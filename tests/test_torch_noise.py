"""The icdf jump sum of ``ops/noise.py``: its plain version against the
expression ``MertonJumpModel.sample_jumps`` wrote inline, the wrapper's
checks and launch counter on the CPU, and (tests marked ``card``, on a CUDA
card: ``python -m pytest tests/test_torch_noise.py --noconftest -m card``)
the kernel ``csrc/icdf_jumps.cu`` bit for bit against the plain version.
Imports no JAX."""

import dataclasses

import pytest
import torch

from deepfbsdejsolvers_torch.models.merton import make_merton_default
from deepfbsdejsolvers_torch.ops import _build
from deepfbsdejsolvers_torch.ops import noise

MU_J = (0.0, -0.1)


def _model(mu_j: float, jump_sampler: str = "icdf"):
    return dataclasses.replace(make_merton_default(jump_sampler=jump_sampler),
                               muJ=mu_j)


def _inline(model, generator, shape):
    """The icdf draw as ``sample_jumps`` wrote it before ``ops/noise.py``."""
    device = generator.device
    u = torch.rand(shape, generator=generator, device=device)
    cdf = model.tables(device)["poisson_cdf"]
    dn = (u[..., None] > cdf).sum(-1).to(torch.float32)
    z = torch.randn(shape, generator=generator, device=device)
    return dn * model.muJ + model.sigJ * torch.sqrt(dn) * z


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The float32 tensor's bit patterns, so that −0 and +0 differ."""
    return t.contiguous().view(torch.int32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("mu_j", MU_J)
def test_plain_and_sample_jumps_equal_the_inline_draw(mu_j):
    model = _model(mu_j)
    shape = (50, 4096)
    want = _inline(model, torch.Generator().manual_seed(7), shape)
    gen = torch.Generator().manual_seed(7)
    got = model.sample_jumps(gen, shape)
    assert _same_bits(got, want)
    # the plain version on the same draws, and the generator left alike
    gen2 = torch.Generator().manual_seed(7)
    u = torch.rand(shape, generator=gen2)
    z = torch.randn(shape, generator=gen2)
    plain = noise.icdf_jumps_plain(u, z, model.tables("cpu")["poisson_cdf"],
                                   model.muJ, model.sigJ)
    assert _same_bits(plain, want)
    assert torch.equal(gen.get_state(), gen2.get_state())
    assert (want != 0).any() and (want == 0).any()


@pytest.mark.parametrize("shape", [(7, 37), (1,), (0,), (3, 0)])
def test_cpu_shapes_take_the_plain_version_and_launch_nothing(shape):
    model = _model(-0.1)
    before = noise.icdf_jumps.launches
    got = model.sample_jumps(torch.Generator().manual_seed(3), shape)
    want = _inline(model, torch.Generator().manual_seed(3), shape)
    assert _same_bits(got, want)
    assert noise.icdf_jumps.launches == before


def _inputs(shape=(4, 6)):
    g = torch.Generator().manual_seed(1)
    u = torch.rand(shape, generator=g)
    z = torch.randn(shape, generator=g)
    return u, z, _model(0.0).tables("cpu")["poisson_cdf"]


@pytest.mark.parametrize("case", [
    "u_strided", "z_strided", "shapes", "u_float64", "z_float64",
    "cdf_float64", "cdf_2d", "cdf_empty", "cdf_too_long"])
def test_checks_raise_before_any_build(case, monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    u, z, cdf = _inputs()
    if case == "u_strided":
        u = u.t()
        z = z.t().contiguous()
    elif case == "z_strided":
        u = u.t().contiguous()
        z = z.t()
    elif case == "shapes":
        z = z[:3]
    elif case == "u_float64":
        u = u.double()
    elif case == "z_float64":
        z = z.double()
    elif case == "cdf_float64":
        cdf = cdf.double()
    elif case == "cdf_2d":
        cdf = cdf[None]
    elif case == "cdf_empty":
        cdf = cdf[:0]
    else:
        cdf = torch.linspace(0.0, 1.0, noise.MAX_TABLE + 1)
    before = noise.icdf_jumps.launches
    with pytest.raises(ValueError):
        noise.icdf_jumps(u, z, cdf, 0.0, 0.2)
    assert noise.icdf_jumps.launches == before


def test_exact_sampler_keeps_its_draw_and_launches_nothing():
    model = _model(0.0, jump_sampler="exact")
    before = noise.icdf_jumps.launches
    j = model.sample_jumps(torch.Generator().manual_seed(5), (50, 512))
    assert j.shape == (50, 512) and noise.icdf_jumps.launches == before


# ---------------------------------------------------------------- the card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# the cell's shape, a smaller (N, B), a ragged tail, one element, none, the
# MC compensator's (N, n_mc)
CARD_SHAPES = [(50, 2**20), (50, 8192), (7, 37), (1,), (0,), (50, 5000)]


@pytest.mark.card
@pytest.mark.parametrize("mu_j", MU_J)
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_kernel_equals_plain_bit_for_bit(shape, mu_j):
    dev = _card()
    model = _model(mu_j)
    cdf = model.tables("cpu")["poisson_cdf"]
    g = torch.Generator(device=dev).manual_seed(11)
    u = torch.rand(shape, generator=g, device=dev)
    z = torch.randn(shape, generator=g, device=dev)
    before = noise.icdf_jumps.launches
    got = noise.icdf_jumps(u, z, cdf, model.muJ, model.sigJ)
    want = noise.icdf_jumps_plain(u, z, cdf.to(dev), model.muJ, model.sigJ)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    assert noise.icdf_jumps.launches == before + (u.numel() > 0)


@pytest.mark.card
@pytest.mark.parametrize("lam, k_range", [(3.0, (9, 32)), (60.0, (33, 128)),
                                          (300.0, (129, 512))])
@pytest.mark.parametrize("shape", [(64, 1000), (4099,)])
def test_kernel_on_long_tables(lam, k_range, shape):
    """One step of a year (λ·dt = 3, 60, 300): the tables of 19, 113 and 411
    entries, ending in float32 ones, take the kernel's instances for 32,
    128 and 512 entries."""
    dev = _card()
    model = dataclasses.replace(_model(-0.1), N=1, lam=lam)
    cdf = model.tables("cpu")["poisson_cdf"]
    assert k_range[0] <= cdf.shape[0] <= k_range[1]
    g = torch.Generator(device=dev).manual_seed(13)
    u = torch.rand(shape, generator=g, device=dev)
    z = torch.randn(shape, generator=g, device=dev)
    got = noise.icdf_jumps(u, z, cdf, model.muJ, model.sigJ)
    want = noise.icdf_jumps_plain(u, z, cdf.to(dev), model.muJ, model.sigJ)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


@pytest.mark.card
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_kernel_on_unaligned_views(offset):
    """Views that start off a 16-byte boundary take the scalar form."""
    dev = _card()
    model = _model(-0.1)
    cdf = model.tables("cpu")["poisson_cdf"]
    g = torch.Generator(device=dev).manual_seed(12)
    n = 4 * 1000 + 3
    u = torch.rand(n + offset, generator=g, device=dev)[offset:]
    z = torch.randn(n + offset, generator=g, device=dev)[offset:]
    got = noise.icdf_jumps(u, z, cdf, model.muJ, model.sigJ)
    want = noise.icdf_jumps_plain(u, z, cdf.to(dev), model.muJ, model.sigJ)
    torch.cuda.synchronize()
    assert _same_bits(got, want)


@pytest.mark.card
@pytest.mark.parametrize("shape", [(50, 2**20), (50, 5000), (8192,)])
def test_sample_jumps_on_the_card(shape):
    """The kernel path leaves J and the generator as the inline draw does,
    one launch a call; the exact sampler launches none."""
    dev = _card()
    model = _model(0.0)
    gen = torch.Generator(device=dev).manual_seed(2**31 + 5)
    ref = torch.Generator(device=dev).manual_seed(2**31 + 5)
    before = noise.icdf_jumps.launches
    for k in range(3):
        got = model.sample_jumps(gen, shape)
        want = _inline(model, ref, shape)
        assert _same_bits(got, want)
        assert torch.equal(gen.get_state(), ref.get_state())
        assert noise.icdf_jumps.launches == before + k + 1
    exact = _model(0.0, jump_sampler="exact")
    before = noise.icdf_jumps.launches
    exact.sample_jumps(gen, shape)
    assert noise.icdf_jumps.launches == before
