"""The one build path of the port's CUDA kernels and of another tree's
(``_build.build_sources``), on the CPU without nvcc: a library is named by
its tree's sources and the compiler flags, so two trees of different
sources never share a library path (a second ``dlopen`` of one path
returns the first library), and the same sources keep one path."""

import shutil

from safe_control_tpu_torch import _build


def _tree(root, kernel: str, header: str):
    """A tree of one kernel ``k.cu`` that includes its header ``k.h``."""
    root.mkdir(parents=True, exist_ok=True)
    (root / "k.h").write_text(header)
    (root / "k.cu").write_text('#include "k.h"\n' + kernel)
    return root / "k.cu"


def test_a_library_is_named_by_its_tree_sources(tmp_path):
    kernel, header = 'extern "C" int f() { return K; }\n', "#define K 1\n"
    a = _tree(tmp_path / "a", kernel, header)
    same = _tree(tmp_path / "b", kernel, header)
    assert _build._library_path(a) == _build._library_path(same)
    first = _build._library_path(a)
    _tree(tmp_path / "a", kernel.replace("K;", "K + 1;"), header)  # the same tree, rewritten
    assert _build._library_path(a) != first
    _tree(tmp_path / "a", kernel, "#define K 2\n")  # a header changed
    assert _build._library_path(a) not in (first, _build._library_path(same))
    (tmp_path / "b" / "extra.h").write_text("")  # a header added
    assert _build._library_path(same) != first
    # A copy of the package's sources: the same name as the package's
    # library, under build/kernels/ab/, while the package's stays in
    # build/kernels/.
    ours = _build._CSRC / "qp_admm_kernel.cu"
    copy = tmp_path / "copy"
    copy.mkdir()
    for f in [ours] + sorted(_build._CSRC.glob("*.h")):
        shutil.copy(f, copy / f.name)
    theirs = _build._library_path(copy / "qp_admm_kernel.cu")
    assert _build._library_path(ours).parent == _build.BUILD_DIR
    assert theirs == _build.BUILD_DIR / "ab" / _build._library_path(ours).name
