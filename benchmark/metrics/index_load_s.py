"""Wall seconds of GenomeIndex.load in set-up (the warm-up call's load
through cli._load_index_cached)."""


def read(record):
    return record["index_load_s"] or None
