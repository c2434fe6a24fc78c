"""Padded sub-grid extraction (``kernels.extract``, ``hydro.state``): the
``out=`` form, the torch path against an index-by-index oracle in numpy,
and on the card the kernel against the torch path, bit for bit.

The file imports neither JAX nor the reference, so its card tests run on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest --noconftest -q tests/test_torch_extract.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.amr_sedov import CONFIG as ACFG  # noqa: E402
from repro_torch.hydro.state import (  # noqa: E402
    _fine_fill_ghosts, amr_sedov_init, extract_padded, extract_subgrids,
    extract_subgrids_multilevel, sync_coarse,
)
from repro_torch.kernels import extract as ext  # noqa: E402

NUMPY_PAD = {"outflow": "edge", "periodic": "wrap"}


def _level(seed, n, f=5, dtype=torch.float32, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((f, n, n, n), generator=g).to(dtype).to(device)


def _oracle(up: np.ndarray, subgrid: int, ghost: int) -> np.ndarray:
    """Padded (F, M, M, M) -> (G^3, F, P, P, P), slot by slot."""
    p = subgrid + 2 * ghost
    grids = (up.shape[-1] - 2 * ghost) // subgrid
    out = []
    for gx in range(grids):
        for gy in range(grids):
            for gz in range(grids):
                x, y, z = gx * subgrid, gy * subgrid, gz * subgrid
                out.append(up[:, x:x + p, y:y + p, z:z + p])
    return np.stack(out)


def _amr_state(device="cpu"):
    st = amr_sedov_init(ACFG, device="cpu")
    g = torch.Generator().manual_seed(5)
    uc = st.uc * (1 + 0.1 * torch.rand(st.uc.shape, generator=g))
    uf = st.uf * (1 + 0.1 * torch.rand(st.uf.shape, generator=g))
    return uc.to(device), uf.to(device)


# -- the torch path, on the CPU ---------------------------------------------

@pytest.mark.parametrize("ghost", [0, 3])
@pytest.mark.parametrize("grids", [1, 2, 4])
@pytest.mark.parametrize("bc", ["outflow", "periodic"])
def test_out_form_equals_allocating_form_and_the_oracle(bc, grids, ghost):
    s = 4
    u = _level(grids, grids * s)
    want = _oracle(np.pad(u.numpy(), [(0, 0)] + [(ghost, ghost)] * 3,
                          mode=NUMPY_PAD[bc]), s, ghost)
    got = extract_subgrids(u, s, ghost, bc)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full_like(got, float("nan"))
    assert extract_subgrids(u, s, ghost, bc, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("ghost", [0, 3])
@pytest.mark.parametrize("grids", [1, 2, 4])
def test_padded_out_form_from_a_strided_level(grids, ghost):
    s = 4
    m = grids * s + 2 * ghost
    big = _level(7, m + 3)
    up = big[:, 1:1 + m, 2:2 + m, 0:m]            # not contiguous
    want = _oracle(up.numpy(), s, ghost)
    got = extract_padded(up, s, ghost)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.empty_like(got)
    assert extract_padded(up, s, ghost, out=out) is out
    assert torch.equal(out, got)


@pytest.mark.parametrize("bc", ["outflow", "periodic"])
def test_multilevel_out_pair_equals_allocating_form(bc):
    uc, uf = _amr_state()
    want = extract_subgrids_multilevel(uc, uf, ACFG, bc)
    out = tuple(torch.full_like(w, float("nan")) for w in want)
    got = extract_subgrids_multilevel(uc, uf, ACFG, bc, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_extraction_refuses_what_it_cannot_write():
    u = _level(1, 8)
    with pytest.raises(ValueError, match="unknown boundary condition"):
        extract_subgrids(u, 4, 3, "reflecting")
    with pytest.raises(ValueError, match="out= must be"):
        extract_subgrids(u, 4, 3, out=torch.empty(8, 5, 10, 10, 9))
    with pytest.raises(ValueError, match="out= must be"):
        extract_subgrids(u, 4, 3, out=torch.empty(8, 5, 10, 10, 10,
                                                  dtype=torch.float64))
    with pytest.raises(ValueError, match="no whole number"):
        extract_subgrids(u, 3, 1)
    with pytest.raises(ValueError, match="wraps more"):
        extract_subgrids(_level(1, 2), 2, 3, "periodic")


# -- the kernel, on the card ------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda", 0)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("ghost", [0, 3])
@pytest.mark.parametrize("bc", ["outflow", "periodic"])
@pytest.mark.parametrize("subgrid,grids", [(8, 4), (16, 2), (5, 3)])
def test_kernel_bit_equal_to_the_torch_path(dev, subgrid, grids, bc, ghost):
    u = _level(subgrid, grids * subgrid, device=dev)
    before = ext.extract_cuda.launches
    got = extract_subgrids(u, subgrid, ghost, bc)
    assert ext.extract_cuda.launches == before + 1
    want = ext.extract_plain(u, subgrid, ghost, bc)
    assert torch.equal(got, want)
    out = torch.full_like(want, float("nan"))
    assert ext.extract_cuda(u, subgrid, ghost, bc, out=out) is out
    assert torch.equal(out, want)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16])
def test_kernel_moves_the_bits_of_other_dtypes(dev, dtype):
    u = (_level(3, 16, dtype=torch.float64) * 1000).to(dtype).to(dev)
    for ghost in (0, 3):
        got = ext.extract_cuda(u, 8, ghost, "outflow")
        assert got.dtype == dtype
        assert torch.equal(got, ext.extract_plain(u, 8, ghost, "outflow"))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
def test_kernel_from_a_strided_padded_level_into_a_misaligned_out(dev,
                                                                  offset):
    """A padded level that is a slice of a larger tensor, written at an
    element offset into a larger buffer (not 16-byte aligned for offset 1
    and 3: the instance that stores one element at a time)."""
    s, g, grids = 8, 3, 2
    m = grids * s + 2 * g
    big = _level(11, m + 4, device=dev)
    up = big[:, 2:2 + m, 1:1 + m, 3:3 + m]
    want = ext.extract_plain(up, s, g, "padded")
    flat = torch.full((want.numel() + offset,), float("nan"), device=dev)
    out = flat[offset:].view(want.shape)
    assert extract_padded(up, s, g, out=out) is out
    assert torch.equal(out, want)
    assert torch.isnan(flat[:offset]).all()


@pytest.mark.requires_cuda
@pytest.mark.parametrize("bc", ["outflow", "periodic"])
def test_kernel_on_both_amr_levels(dev, bc):
    uc, uf = _amr_state(dev)
    got = extract_subgrids_multilevel(uc, uf, ACFG, bc)
    ucs = sync_coarse(uc, uf, ACFG)
    want_c = ext.extract_plain(ucs, ACFG.coarse_subgrid, ACFG.ghost, bc)
    want_f = ext.extract_plain(_fine_fill_ghosts(ucs, uf, ACFG),
                               ACFG.fine_subgrid, ACFG.ghost, "padded")
    assert torch.equal(got[0], want_c) and torch.equal(got[1], want_f)


@pytest.mark.requires_cuda
def test_kernel_refuses_without_falling_back(dev):
    u = _level(2, 16, device=dev)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        ext.extract_cuda(u.cpu(), 8, 3, "outflow")
    with pytest.raises(ValueError, match="out= must be"):
        ext.extract_cuda(u, 8, 3, "outflow",
                         out=torch.empty(8, 5, 14, 14, 14, device=dev)[:, :4])
    with pytest.raises(TypeError, match="2, 4 or 8 bytes"):
        ext.extract_cuda(u.to(torch.uint8), 8, 3, "outflow")
    with pytest.raises(RuntimeError, match="no backward"):
        ext.extract_cuda(u.requires_grad_(), 8, 3, "outflow")
