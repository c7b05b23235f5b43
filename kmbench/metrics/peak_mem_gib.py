"""The card's peak allocated memory over set-up and window
(``torch.cuda.max_memory_allocated``), GiB."""

def read(data):
    return data["peak_bytes"] / 2 ** 30 if data["peak_bytes"] else None
