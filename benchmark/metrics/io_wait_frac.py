"""Share of the CLI's align loop spent reading FASTQ and writing SAM:
(AlignerStats.seconds_reading + seconds_writing) / align_seconds."""


def read(record):
    s = record["stats"]
    if not s["align_seconds"]:
        return None
    return (s["seconds_reading"] + s["seconds_writing"]) / s["align_seconds"]
