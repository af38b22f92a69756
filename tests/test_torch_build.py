"""The port's kernel build (``ops/cuda/build.py``), driven with a stand-in
for nvcc: a library is rebuilt only when its source changes, and a failed
build raises with the compiler's stderr."""

import pytest

from srganfd_tpu_torch.ops.cuda import build

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
{body}
"""
WRITE_OUTPUT = 'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && echo lib > "$2"; shift; done'


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A csrc dir with one source, an empty build dir, and a stand-in nvcc
    whose body the test picks; returns (source, log, set_body)."""
    csrc, log = tmp_path / "csrc", tmp_path / "nvcc.log"
    csrc.mkdir()
    src = csrc / "k.cu"
    src.write_text("extern \"C\" int k() { return 0; }\n")
    nvcc = tmp_path / "nvcc"
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build" / "kernels")
    monkeypatch.setattr(build, "_nvcc", lambda: str(nvcc))

    def set_body(body):
        nvcc.write_text(FAKE_NVCC.format(log=log, body=body))
        nvcc.chmod(0o755)

    return src, log, set_body


def test_build_reuses_the_library_until_the_source_changes(fake_build):
    src, log, set_body = fake_build
    set_body(WRITE_OUTPUT)
    first = build.build("k")
    assert first.read_text() == "lib\n" and first.parent == build.BUILD_DIR
    assert "arch=compute_90a,code=sm_90a" in log.read_text()
    assert build.build("k") == first
    assert len(log.read_text().splitlines()) == 1  # no second nvcc run
    src.write_text(src.read_text() + "// edited\n")
    second = build.build("k")
    assert second != first and second.exists()
    assert len(log.read_text().splitlines()) == 2
    assert build.build_all() == ["k"]  # every source already built


def test_failed_build_raises_with_nvcc_stderr(fake_build):
    _, _, set_body = fake_build
    set_body('echo "k.cu(1): error: identifier \\"oops\\" is undefined" >&2\nexit 2')
    with pytest.raises(RuntimeError, match='nvcc failed to build k.cu:\n.*"oops" is undefined'):
        build.build("k")
    assert not list(build.BUILD_DIR.iterdir())  # no library, no partial file left behind


def test_a_build_with_defines_is_a_library_apart(fake_build):
    """``defines`` (the kernels' ``SRGANFD_PROBE`` counters) reach nvcc as
    ``-D`` flags and build a library beside the plain one, which stays as it
    was; each is reused."""
    _, log, set_body = fake_build
    set_body(WRITE_OUTPUT)
    plain = build.build("k")
    probe = build.build("k", ("SRGANFD_PROBE",))
    assert probe != plain and plain.exists() and probe.exists()
    lines = log.read_text().splitlines()
    assert len(lines) == 2 and "-DSRGANFD_PROBE" not in lines[0] and "-DSRGANFD_PROBE" in lines[1]
    assert build.build("k", ("SRGANFD_PROBE",)) == probe and build.build("k") == plain
    assert len(log.read_text().splitlines()) == 2
