"""Start the processes of one torch.distributed world and join them.

A torch.distributed world is one process per rank. ``spawn`` starts them
from a parent (a script, a test or ``entry.dryrun_multichip``), each with
its own command line and its output in ``log_dir/log_<rank>.txt``, waits for
all with a deadline, kills every survivor as soon as one fails or the
deadline passes, and raises with the failures' output. The ranks meet
through a file under ``log_dir`` (``store_url``): no TCP port, so two worlds
on one machine cannot collide.
"""

from __future__ import annotations

import os
import subprocess
import time
from pathlib import Path
from typing import Mapping, Optional, Sequence


def store_url(log_dir) -> str:
    """The ``init_method`` of the world's ``FileStore`` under ``log_dir``."""
    return f"file://{Path(log_dir).resolve() / 'store'}"


def spawn(argvs: Sequence[Sequence[str]], log_dir, deadline: float,
          env: Optional[Mapping[str, str]] = None, cwd=None) -> None:
    """Run one process per command line of ``argvs`` (rank r runs
    ``argvs[r]``) and wait for all of them, at most ``deadline`` seconds.
    Raises ``RuntimeError`` with the exit codes and the tail of every
    rank's log when a rank exits non-zero or the deadline passes; no
    process is left running either way."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    logs = [open(log_dir / f"log_{r}.txt", "w+") for r in range(len(argvs))]
    procs = []
    try:
        for argv, log in zip(argvs, logs):
            procs.append(subprocess.Popen(list(argv), cwd=cwd, env=None if env is None else
                                          dict(env), stdout=log, stderr=subprocess.STDOUT))
        end = time.monotonic() + deadline
        while any(p.poll() is None for p in procs):
            if time.monotonic() > end or any(p.poll() not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    codes = [p.returncode for p in procs]
    tails = []
    for r, log in enumerate(logs):
        log.seek(0)
        tails.append(f"--- rank {r} (exit {codes[r]}) ---\n{log.read()[-3000:]}")
        log.close()
    if any(c != 0 for c in codes):
        raise RuntimeError(f"a world of {len(argvs)} failed (exit codes {codes}; a negative "
                           f"code is a signal, the deadline was {deadline} s):\n"
                           + "\n".join(tails))


def rank_env(extra: Optional[Mapping[str, str]] = None, pythonpath=None) -> dict:
    """The parent's environment for a rank: ``WORLD_SIZE`` and ``RANK``
    removed (each rank is told its own), ``pythonpath`` put first on
    ``PYTHONPATH``, then ``extra``."""
    env = dict(os.environ)
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        env.pop(k, None)
    if pythonpath is not None:
        env["PYTHONPATH"] = os.pathsep.join([str(pythonpath), os.environ.get("PYTHONPATH", "")])
    env.update(extra or {})
    return env
