"""The kernel library's build (``ops/_build.py``) on the CPU, with a stand-in
for nvcc: every source in one call with the package's headers on the
include path (a copy of a source kept elsewhere still finds them); a
failing nvcc raises and leaves no library; a header newer than the library
makes it stale."""

import os
import stat
import sys
import textwrap

import pytest

from rabbit_transcoding_tpu_torch.ops import _build


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in nvcc: appends its arguments to ``calls.txt``, writes its
    ``-o`` target, and fails on a source named ``bad.cu``."""
    calls = tmp_path / "calls.txt"
    script = tmp_path / "nvcc"
    script.write_text(textwrap.dedent(f"""\
        #!{sys.executable}
        import sys
        args = sys.argv[1:]
        with open({str(calls)!r}, "a") as f:
            f.write(" ".join(args) + "\\n")
        if any(a.endswith("bad.cu") for a in args):
            print("ptxas error", file=sys.stderr)
            sys.exit(2)
        open(args[args.index("-o") + 1], "w").write("built")
        """))
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(script))
    return calls


def test_one_call_builds_every_source_with_the_headers_found(fake_nvcc,
                                                             tmp_path):
    srcs = [tmp_path / "elsewhere" / f"{n}.cu" for n in ("one", "two")]
    lib, log = tmp_path / "out" / "lib.so", tmp_path / "out" / "build.log"
    _build.compile_library(srcs, lib, log)
    assert lib.read_text() == "built"
    (call,) = fake_nvcc.read_text().splitlines()
    args = call.split()
    assert args[args.index("-I") + 1] == str(_build.CSRC)
    assert args[-2:] == [str(s) for s in srcs]
    assert log.read_text().startswith(str(_build.nvcc()))
    assert not list(lib.parent.glob("*.tmp"))


def test_a_failing_nvcc_raises_and_leaves_no_library(fake_nvcc, tmp_path):
    lib = tmp_path / "lib.so"
    with pytest.raises(RuntimeError, match="ptxas error"):
        _build.compile_library([tmp_path / "bad.cu"], lib,
                               tmp_path / "build.log")
    assert not lib.exists() and not list(tmp_path.glob("*.tmp"))


def test_a_newer_header_makes_the_library_stale(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("")
    (csrc / "h.cuh").write_text("")
    lib = tmp_path / "lib.so"
    lib.write_text("")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "LIBRARY", lib)
    past = lib.stat().st_mtime - 10
    for f in (csrc / "k.cu", csrc / "h.cuh"):
        os.utime(f, (past, past))
    assert not _build._stale()
    os.utime(csrc / "h.cuh", (past + 20, past + 20))
    assert _build._stale()
