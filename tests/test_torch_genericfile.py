"""io/genericfile.py (the GenericFile family: GenericFile.cpp:108's
factory, stdio/Blob/map, and the http(s) stand-in for GenericFile_HDFS)
in snap_tpu_torch against snap_tpu (the twins of
tests/test_genericfile.py). Each case reads through both packages and
must get the same bytes, errors and answers; the http cases serve a
temporary directory on a loopback port (no network)."""

import functools
import gzip
import http.server
import threading

import numpy as np
import pytest

import snap_tpu.io.genericfile as J
import snap_tpu_torch.io.genericfile as T

MODS = (J, T)


def read_both(path, **kw):
    out = []
    for m in MODS:
        with m.open_generic(path, **kw) as f:
            out.append(f.read())
    assert out[1] == out[0]
    return out[1]


def test_plain_and_gzip(tmp_path):
    p = tmp_path / "a.txt"
    p.write_bytes(b"hello\nworld\n")
    assert read_both(str(p)) == b"hello\nworld\n"
    gz = tmp_path / "a.txt.gz"
    with gzip.open(gz, "wb") as f:
        f.write(b"zipped")
    assert read_both(str(gz)) == b"zipped"
    assert read_both(str(gz), gzipped=False)[:2] == b"\x1f\x8b"
    plain_named_gz = tmp_path / "b.txt"
    plain_named_gz.write_bytes(gzip.compress(b"forced"))
    assert read_both(str(plain_named_gz), gzipped=True) == b"forced"


def test_file_scheme(tmp_path):
    p = tmp_path / "b.txt"
    p.write_bytes(b"via-url")
    assert read_both("file://" + str(p)) == b"via-url"
    for m in MODS:
        assert m.exists_generic("file://" + str(p))
        assert not m.exists_generic("file://" + str(p) + ".nope")
        assert m.exists_generic(str(p)) and not m.exists_generic(str(p) + ".nope")


def test_blob_and_mmap(tmp_path):
    p = tmp_path / "m.bin"
    p.write_bytes(bytes(range(64)))
    for m in MODS:
        b = m.BlobFile(b"in-memory image")
        assert b.read(9) == b"in-memory"
        mm = m.open_mapped(str(p))
        assert bytes(mm[:4]) == b"\x00\x01\x02\x03"
        assert np.frombuffer(mm, np.uint8)[63] == 63
        mm.close()


def test_unregistered_scheme_is_instructive():
    msgs = []
    for m in MODS:
        with pytest.raises(IOError, match="register_scheme") as e:
            m.open_generic("hdfs://nn/part0.fa")
        msgs.append(str(e.value))
        assert not m.exists_generic("hdfs://nn/part0.fa")
    # the same message, naming each package's own register_scheme
    assert msgs[1] == msgs[0].replace("snap_tpu.", "snap_tpu_torch.")


def test_registered_scheme(tmp_path):
    p = tmp_path / "remote.bin"
    p.write_bytes(b"remote payload")

    def fake_opener(url, mode):
        assert url.startswith("fake://")
        return open(str(p), mode)

    for m in MODS:
        m.register_scheme("fake", fake_opener)
    try:
        assert read_both("fake://bucket/remote.bin") == b"remote payload"
        assert all(m.exists_generic("fake://anything") for m in MODS)
    finally:
        for m in MODS:
            m._SCHEMES.pop("fake", None)
    assert not T.exists_generic("fake://anything")


def test_fasta_loader_goes_through_factory(tmp_path):
    from snap_tpu.genome import load_fasta as jload
    from snap_tpu_torch.genome import load_fasta as tload

    p = tmp_path / "g.fa.gz"
    with gzip.open(p, "wb") as f:
        f.write(b">c1 desc\nACGTACGT\n>c2\nGG\n")
    a, b = jload("file://" + str(p)), tload("file://" + str(p))
    assert [(c.name, c.start, c.length) for c in b.contigs] == [
        (c.name, c.start, c.length) for c in a.contigs
    ]
    np.testing.assert_array_equal(b.bases, a.bases)
    assert b.contigs[0].name == "c1" and b.contigs[0].length == 8


@pytest.fixture
def served(tmp_path):
    handler = functools.partial(http.server.SimpleHTTPRequestHandler, directory=str(tmp_path))
    httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    yield tmp_path, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def test_http_scheme_ships_by_default(served):
    root, base = served
    (root / "r.fq").write_bytes(b"@r1\nACGT\n+\nIIII\n")
    with gzip.open(root / "r.fq.gz", "wb") as f:
        f.write(b"@r2\nTTTT\n+\nIIII\n")
    assert read_both(f"{base}/r.fq") == b"@r1\nACGT\n+\nIIII\n"
    assert read_both(f"{base}/r.fq.gz") == b"@r2\nTTTT\n+\nIIII\n"
    for m in MODS:
        with pytest.raises(IOError, match="read-only"):
            m.open_generic(f"{base}/out.sam", "wb")


def test_http_fastq_input_end_to_end(served):
    from snap_tpu.io.fastq import read_batches as jread
    from snap_tpu_torch.io.fastq import read_batches as tread

    root, base = served
    recs = b"".join(b"@q%d\nACGTACGTAC\n+\nIIIIIIIIII\n" % i for i in range(7))
    (root / "in.fq").write_bytes(recs)
    got = list(tread(f"{base}/in.fq", 4, 16))
    ref = list(jread(f"{base}/in.fq", 4, 16))
    assert [b.ids for b in got] == [b.ids for b in ref]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.bases, a.bases)
        np.testing.assert_array_equal(b.quals, a.quals)
        np.testing.assert_array_equal(b.lengths, a.lengths)
    ids = [i for b in got for i in b.ids]
    assert len(ids) == 7 and ids[0] == b"q0" and ids[-1] == b"q6"
