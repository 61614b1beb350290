"""The native FASTQ scanner through snap_tpu_torch.io.native against
snap_tpu.io.native (the twins of tests/test_native_io.py's parse cases;
BGZF is in test_torch_output.py): the max-length clamp, malformed input,
and the record fields of a mixed buffer."""

import numpy as np
import pytest

from snap_tpu.io import native as J
from snap_tpu_torch.io import native as T

pytestmark = pytest.mark.skipif(
    not (J.available() and T.available()), reason="native library unavailable"
)


def same_parse(buf, max_reads, max_len):
    a = J.parse_fastq_buffer(buf, max_reads, max_len)
    b = T.parse_fastq_buffer(buf, max_reads, max_len)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x)
        else:
            assert y == x
    return b


def test_parse_fastq_buffer_matches_reference():
    buf = (
        b"@r1 with comment\nACGTNACGT\n+\nIIIIIIIII\n"
        b"@r2\nacgtn\n+anything\nJJJJJ\n"
        b"@r3_incomplete\nACGT\n+\nII"
    )
    n, bases, quals, lens, ids, consumed = same_parse(buf, 10, 12)
    assert n == 2 and ids == [b"r1 with comment", b"r2"]
    assert bases[1, :5].tolist() == [0, 1, 2, 3, 5]
    assert buf[consumed:].startswith(b"@r3_incomplete")


@pytest.mark.parametrize("max_len", [1, 99, 100, 101, 299, 300])
def test_parse_fastq_max_len_clamp(max_len):
    buf = b"@r\n" + b"A" * 300 + b"\n+\n" + b"I" * 300 + b"\n" + b"@s\nACGT\n+\nIIII\n"
    n, bases, quals, lens, ids, consumed = same_parse(buf, 4, max_len)
    assert n == 2 and lens[0] == max_len and lens[1] == min(4, max_len)
    assert consumed == len(buf)


def test_parse_fastq_max_reads():
    buf = b"".join(b"@r%d\nACGT\n+\nIIII\n" % i for i in range(5))
    n, *_, consumed = same_parse(buf, 3, 8)
    assert n == 3 and buf[consumed:].startswith(b"@r3")


@pytest.mark.parametrize("buf", [
    b"not a fastq\nACGT\n+\nIIII\n",
    b"@r1\nACGT\nIIII\nIIII\n",
    b"@r1\nACGT\n+\nIIII\nXr2\nACGT\n+\nIIII\n",
])
def test_parse_fastq_malformed(buf):
    with pytest.raises(ValueError) as ej:
        J.parse_fastq_buffer(buf, 4, 10)
    with pytest.raises(ValueError) as et:
        T.parse_fastq_buffer(buf, 4, 10)
    assert str(et.value) == str(ej.value)
