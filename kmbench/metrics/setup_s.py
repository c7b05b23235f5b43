"""Process start to the first timed request or step, host clock: imports,
the kernels' build or load, weights and volumes, warm-up."""

def read(data):
    return data["setup_s"]
