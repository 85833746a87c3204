"""The port's kernel build (`ops/kernels/build.py`), on the CPU: which
sources a library's name covers. Nothing is compiled here."""

from __future__ import annotations

from kubernetes_autoscaler_tpu_torch.ops.kernels import build


def test_library_name_changes_when_only_a_header_changes(tmp_path):
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = build.library_path("k.cu", tmp_path)
    assert build.library_path("k.cu", tmp_path) == first
    assert first.name.startswith("libk-") and first.parent == build.BUILD_DIR
    (tmp_path / "h.cuh").write_text("// two\n")
    edited = build.library_path("k.cu", tmp_path)
    assert edited != first
    (tmp_path / "other.cuh").write_text("")           # a new header
    added = build.library_path("k.cu", tmp_path)
    assert added not in (first, edited)
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n// edited\n')
    assert build.library_path("k.cu", tmp_path) not in (first, edited, added)


def test_both_kernels_include_the_shared_row_pass():
    header = build.CSRC_DIR / "pack_row.cuh"
    assert header.exists()
    for source in ("pack.cu", "wavefront.cu"):
        assert '#include "pack_row.cuh"' in (build.CSRC_DIR / source).read_text()
    # the real libraries' names cover the header too
    names = {build.library_path(s) for s in ("pack.cu", "wavefront.cu")}
    assert len(names) == 2
