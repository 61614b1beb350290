"""tests/test_torch_single.py's CLI twin on the uniform random genome:
the same index files and byte-identical SAM from snap_tpu_torch and
snap_tpu (in a file of its own, so it runs beside the repeat genome's)."""

import pytest

from test_torch_pipeline import same_logq  # noqa: F401
from test_torch_single import (  # noqa: F401
    runs,
    test_host_branches_ran,
    test_index_files_match,
    test_sam_byte_identical,
)


@pytest.fixture(scope="module")
def kind():
    return "random"
