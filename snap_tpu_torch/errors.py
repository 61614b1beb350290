"""Status/error message routing with -q/-qq suppression and -hdp
Hadoop streaming prefixes.

Behavioral reference: WriteStatusMessage/WriteErrorMessage with the
global g_suppressStatusMessages / g_suppressErrorMessages flags
(Error.h:28-31, AlignerOptions.h:90-91) and the `reporter:status:` /
`reporter:counter:` prefixes emitted under -hdp (Error.cpp:33,96).
"""

from __future__ import annotations

import sys

_suppress_status = False
_suppress_errors = False
_hadoop_mode = False


def configure(quiet: bool = False, very_quiet: bool = False,
              hadoop: bool = False) -> None:
    global _suppress_status, _suppress_errors, _hadoop_mode
    _suppress_status = quiet or very_quiet
    _suppress_errors = very_quiet
    _hadoop_mode = hadoop


def write_status(msg: str) -> None:
    if _suppress_status:
        return
    if _hadoop_mode:
        sys.stderr.write(f"reporter:status:{msg}\n")
    else:
        sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def write_error(msg: str) -> None:
    if _suppress_errors:
        return
    sys.stderr.write(msg + "\n")
    sys.stderr.flush()


def hadoop_counter(name: str, value: int) -> None:
    """reporter:counter:SNAP,<name>,<value> keepalives (Error.cpp:96)."""
    if _hadoop_mode:
        sys.stderr.write(f"reporter:counter:SNAP,{name},{value}\n")
        sys.stderr.flush()
