"""Peak of the card's allocated memory over the window, in GiB:
torch.cuda.max_memory_allocated() after reset_peak_memory_stats() at the
window's start."""


def read(record):
    b = record["card_peak_bytes"]
    return b / 2**30 if b else None
