"""The float32 K1 stage's TMA-fed TF32 wgmma kernel
(``csrc/band_wgmma.cu``, ``tt_band_conv_wgmma_f32``) on the CPU: its box
and tile plan (``band_tma_plan_f32``), the zero padding of a ragged T
(``tma_frames``), the weights' TF32 planes
(``ConvBlocks.band_tf32_operands``) and the routing of ``banded_conv``.

There is no card here, so an emulation walks the plan as the kernel does:
per 64-row sub-tile and 128-frame tile, chunk by chunk of 16 band rows, an
x box of 152 frames from t0 - 8 with zeros outside the tensor, and per tap
the transposed product of x (split into a TF32 hi, rounded to nearest with
ties away, and the float32 remainder lo, whose low 13 bits the tensor cores
drop) with the weights' pre-split hi and lo planes: lo*hi + hi*lo + hi*hi
into a fresh float32 sum, added into the running sum by an IEEE add, chunk
by chunk and tap by tap; then bias, ELU and residual. It is held against
the plain twin (``banded_conv_reference``) on every conv kind and as the
small geometry's whole chain (the twin chain is held against the JAX
package's Pallas chain by ``tests/test_torch_packed.py``), against float64
next to the IEEE float32 twin, and against the JAX package's
``packed_conv_reference`` on two flagship stages. The kernel itself is
held against the twin on the card (``tests/test_torch_kernels.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timbre_trap_tpu.ops import packed_conv as jpc
from timbre_trap_tpu_torch.models import TimbreTrapNet, forward_spec
from timbre_trap_tpu_torch.models.fused import fused_forward
from timbre_trap_tpu_torch.models.modules import init_weights
from timbre_trap_tpu_torch.ops import fused_level as fl
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.utils import profiling

from test_torch_bands import _like, _split_tf32, _tf32_rna

torch.set_num_threads(2)


def _np_rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy(_np_rand(rng, *shape, scale=scale))


def _tf32_trunc(v):
    """The TF32 bits of float32 ``v`` that the tensor cores keep."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def emulate_wgmma_f32(x, cb, act=False, residual=None):
    """``tt_band_conv_wgmma_f32``'s arithmetic on the CPU, in the kernel's
    order of sums (chunk, then tap, each product a fresh float32 sum)."""
    b, r_in, t = x.shape
    plan = fl.band_tma_plan_f32(cb, t)
    xp = fl.tma_frames(x, plan.t_pad)
    planes, bias = cb.band_tf32_operands()
    w_hi, w_lo = planes[:, :, 0], _tf32_trunc(planes[:, :, 1])
    tile, halo = fl.F32_TILE_T, fl.BAND_MAX_DT
    n_f = plan.tiles * tile
    y = torch.zeros((b, plan.n_sub * pc.SUB_ROWS, n_f))
    # The x boxes of every tile side by side: frames t0 - 8 .. t0 + 143 of
    # tile t0, zeros outside [0, t_pad) and outside the input's rows.
    frames = (torch.arange(plan.tiles)[:, None] * tile - halo
              + torch.arange(fl.F32_BOX_T)[None])
    f_ok = (frames >= 0) & (frames < plan.t_pad)
    for g in range(plan.n_sub):
        start, length, chunks = plan.bands[g % 2]
        row0 = cb.sub_start(g)
        wh, wl = w_hi[cb.sub_weights(g)], w_lo[cb.sub_weights(g)]
        run = torch.zeros((b, pc.SUB_ROWS, plan.tiles, tile))
        for c in range(chunks):
            rows = row0 + c * fl.F32_KC + torch.arange(fl.F32_KC)
            r_ok = (rows >= 0) & (rows < r_in)
            box = xp[:, rows.clamp(0, r_in - 1)][:, :, frames.clamp(
                0, plan.t_pad - 1)] * (r_ok[:, None, None] & f_ok[None])
            k = slice(c * fl.F32_KC, (c + 1) * fl.F32_KC)
            for tap, dt in enumerate(plan.taps):
                x_hi, x_lo = _split_tf32(box[..., halo + dt:
                                             halo + dt + tile])
                p_lh, p_hl, p_hh = (
                    torch.einsum("rk,bkjn->brjn", w[tap, :, k], v)
                    for w, v in ((wh, x_lo), (wl, x_hi), (wh, x_hi)))
                run = run + ((p_lh + p_hl) + p_hh)
        y[:, g * pc.SUB_ROWS:(g + 1) * pc.SUB_ROWS] = run.reshape(
            b, pc.SUB_ROWS, n_f)
    y = y[:, :cb.r_out, :t]
    rows = torch.arange(cb.r_out)
    y = y + bias[rows if cb.per_block else rows % pc.BLOCK_ROWS][None, :,
                                                               None]
    if act:
        y = torch.where(y > 0, y, torch.exp(torch.clamp(y, max=0.0)) - 1.0)
    if residual is not None:
        y = y + residual
    return y


def _close(got, want, tol, what):
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    assert err <= tol * scale, (what, err, scale)


def _conv_kinds():
    """One ConvBlocks of every kind the chains hold, at narrow widths."""
    rng = np.random.default_rng(11)
    out = {}
    for d in (1, 2, 3):
        out[f"3x3-d{d}"] = pc.build_conv2d_blocks(
            _rand(rng, 3, 3, 4, 4), _rand(rng, 4), 60, d)
    out["1x1"] = pc.build_conv2d_blocks(_rand(rng, 1, 1, 32, 32),
                                        _rand(rng, 32), 9)
    out["convin"] = pc.build_conv2d_blocks(_rand(rng, 3, 3, 2, 4),
                                           _rand(rng, 4), 60)
    out["convout"] = pc.build_conv2d_blocks(_rand(rng, 3, 3, 4, 1),
                                            _rand(rng, 1), 60)
    out["sconv"] = pc.build_sconv_blocks(_rand(rng, 4, 1, 16, 32),
                                         _rand(rng, 32), 21)
    out["tconv"] = pc.build_tconv_blocks(_rand(rng, 4, 1, 8, 4),
                                         _rand(rng, 4), 37, output_padding=1)
    out["dense-lat"] = pc.build_dense_blocks(_rand(rng, 128, 400, scale=0.05),
                                             _rand(rng, 128))
    out["dense-exp"] = pc.build_dense_blocks(_rand(rng, 300, 128, scale=0.1),
                                             _rand(rng, 300))
    return out


_KINDS = _conv_kinds()


@pytest.fixture(scope="module")
def small_net():
    """The port's net at the small geometry (F=60, latent 16, complexity
    1), seeded."""
    return init_weights(TimbreTrapNet(60, 16, 1),
                        torch.Generator().manual_seed(3))


def _flagship_stage_args():
    """Block constructor and numpy arguments of two flagship stage kinds:
    a residual 3x3 conv at dilation 3 (taps -3, 0, 3 on 2160 rows) and
    the dense bridge 1984 -> 128 (one band of all 1984 columns)."""
    rng = np.random.default_rng(21)
    return {"3x3-d3": ("build_conv2d_blocks",
                       (_np_rand(rng, 3, 3, 4, 4), _np_rand(rng, 4), 540, 3)),
            "bridge": ("build_dense_blocks",
                       (_np_rand(rng, 128, 1984, scale=0.03),
                        _np_rand(rng, 128)))}


def _flagship_stage(kind):
    fn, args = _flagship_stage_args()[kind]
    return getattr(pc, fn)(*[torch.from_numpy(a) if isinstance(a, np.ndarray)
                             else a for a in args])


def test_tf32_planes_split_the_band_weights():
    """The weights' planes: hi is the band weights rounded to TF32 (the
    tests' ``_tf32_rna``, nearest with ties away; no low bits), lo the
    exact float32 remainder, so hi + lo is the band weights bit for bit;
    built once."""
    cb = _KINDS["3x3-d2"]
    planes, bias = cb.band_tf32_operands()
    w, bias32 = cb.band_operands(torch.float32)
    assert planes.shape == (2, len(cb.dts), 2, pc.SUB_ROWS, cb.band_width)
    hi, lo = planes[:, :, 0], planes[:, :, 1]
    assert torch.equal(hi, _tf32_rna(w))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi + lo, w)
    assert torch.equal(bias, bias32)
    assert cb.band_tf32_operands()[0] is planes
    assert torch.equal(pc.tf32_round(w), _tf32_rna(w))


@pytest.mark.parametrize("kind", sorted(_KINDS))
@pytest.mark.parametrize("t", [40, 37])
def test_emulation_matches_twin_on_every_kind(kind, t):
    """Every conv kind, with bias, ELU and residual (none for the dense
    maps) and without: the emulated kernel within 1e-5 * max|ref| of the
    float32 twin (sum order and the split-TF32 products only)."""
    cb = _KINDS[kind]
    rng = np.random.default_rng(t + len(kind))
    x = _rand(rng, 2, cb.r_in, t)
    res = None if cb.per_block else _rand(rng, 2, cb.r_out, t)
    for act, r in ((False, None), (True, res)):
        _close(emulate_wgmma_f32(x, cb, act, r),
               fl.banded_conv_reference(x, cb, act, r), 1e-5, (kind, act))


@pytest.mark.parametrize("t", [40, 37])
def test_emulation_matches_twin_on_small_geometry(small_net, t):
    """Every stage of the small geometry's forward chain, alone, on random
    input with ELU and residual (where the stage may take one): within
    1e-5 * max|ref| of the float32 twin."""
    rng = np.random.default_rng(t)
    convs = list(forward_spec(small_net, True).convs())
    assert len(convs) > 20
    for i, cb in enumerate(convs):
        x = _rand(rng, 2, cb.r_in, t)
        res = None if cb.per_block else _rand(rng, 2, cb.r_out, t)
        _close(emulate_wgmma_f32(x, cb, True, res),
               fl.banded_conv_reference(x, cb, True, res), 1e-5,
               (i, cb.dts, cb.bands))


@pytest.mark.parametrize("kind", sorted(_KINDS))
def test_emulation_error_within_three_times_ieee(kind):
    """Against float64 (the band function of the same weights and input):
    the emulated kernel's largest error at most 3x the IEEE float32
    twin's, the bar ``tools/f32_accuracy.py`` holds the kernel to on the
    card, and inside 1e-5 * max|ref| (``test_split_tf32_error_within_the_
    float32_check``'s bar for the split-TF32 products)."""
    cb = _KINDS[kind]
    x = _rand(np.random.default_rng(4), 2, cb.r_in, 37)
    ref = pc.band_conv_reference(
        x.double(), _like(cb, cb.blocks.double(), cb.bias.double()))
    ieee = fl.banded_conv_reference(x, cb)
    got = emulate_wgmma_f32(x, cb)
    scale = float(ref.abs().max())
    e_got = float((got.double() - ref).abs().max())
    e_ieee = float((ieee.double() - ref).abs().max())
    assert e_got <= 3 * e_ieee, (kind, e_got, e_ieee)
    assert e_got <= 1e-5 * scale


@pytest.mark.parametrize("kind", ["3x3-d3", "bridge"])
def test_emulation_matches_jax_packed_conv(kind):
    """Two flagship stages built from the same numpy weights in both
    packages: the emulated kernel (no ELU or residual) within 1e-5 *
    max|ref| of the JAX package's ``packed_conv_reference``, the plain XLA
    execution of the TPU kernel's banded stage."""
    fn, args = _flagship_stage_args()[kind]
    cb = _flagship_stage(kind)
    x = _np_rand(np.random.default_rng(4), 1, cb.r_in, 40)
    want = np.asarray(jpc.packed_conv_reference(jnp.asarray(x),
                                                getattr(jpc, fn)(*args)))
    got = emulate_wgmma_f32(torch.from_numpy(x), cb).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_emulated_chain_matches_twin_chain(small_net):
    """The small geometry's whole float32 forward, every stage through the
    emulated kernel, against the same chain on the twin, within 1e-4 *
    max|ref| (the card's bar for a whole chain)."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (1, 60, 24, 2)).astype(np.float32))
    want = fused_forward(small_net, x, True)
    real = fl.banded_conv
    fl.banded_conv = emulate_wgmma_f32
    try:
        got = fused_forward(small_net, x, True)
    finally:
        fl.banded_conv = real
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def test_ragged_t_pads_to_the_unpadded_result():
    """A ragged T: ``tma_frames`` hands the kernel x padded with zero
    frames to a multiple of 4, and the stage on it equals the stage on the
    unpadded x, bit for bit in the emulation and within 1e-5 * max|ref|
    of the twin on the unpadded x."""
    cb = _flagship_stage("3x3-d3")
    rng = np.random.default_rng(9)
    x = _rand(rng, 1, cb.r_in, 37)
    plan = fl.band_tma_plan_f32(cb, 37)
    assert plan.t_pad == 40
    xp = fl.tma_frames(x, plan.t_pad)
    assert xp.shape[-1] == 40 and not xp[..., 37:].any()
    assert torch.equal(xp[..., :37], x)
    assert fl.tma_frames(xp, 40) is xp
    got = emulate_wgmma_f32(x, cb, True)
    assert torch.equal(got, emulate_wgmma_f32(xp, cb, True)[..., :37])
    _close(got, fl.banded_conv_reference(x, cb, True), 1e-5, "ragged")


def test_plan_covers_every_tap_and_band(small_net):
    """Every stage of the flagship and the small forward: the plan keeps
    each tap's dt within the box (|dt| <= 8: frames t0 + n + dt of a
    152-frame box from t0 - 8 for n < 128), its chunks of 16 rows cover
    each band exactly, its tiles cover T, T pads to a multiple of 4, and
    the C integers the kernel reads are the plan's."""
    for net in (small_net, TimbreTrapNet(540, 128, 2)):
        for cb in forward_spec(net, True).convs():
            for t in (1024, 1001, 37, 1):
                plan = fl.band_tma_plan_f32(cb, t)
                assert plan.t_pad % fl.F32_FRAME_ALIGN == 0
                assert 0 <= plan.t_pad - t < fl.F32_FRAME_ALIGN
                assert (plan.tiles - 1) * fl.F32_TILE_T < t
                assert plan.tiles * fl.F32_TILE_T >= t
                assert plan.n_sub == cb.n_sub
                assert plan.taps == cb.dts and 1 <= len(plan.taps) <= 3
                for dt in plan.taps:
                    assert 0 <= fl.BAND_MAX_DT + dt
                    assert (fl.BAND_MAX_DT + dt + fl.F32_TILE_T
                            <= fl.F32_BOX_T)
                for (start, length, chunks), band in zip(plan.bands,
                                                         cb.bands):
                    assert (start, length) == band
                    assert chunks * fl.F32_KC == length
                    assert length <= cb.band_width
                t_pad, ints = fl._wgmma_plan_f32(cb, t, cb.band_width)
                taps = list(cb.dts) + [0] * (3 - len(cb.dts))
                assert t_pad == plan.t_pad
                assert list(ints) == [t, plan.t_pad, len(cb.dts), *taps,
                                      cb.col_adv, cb.margin, cb.band_width,
                                      plan.n_w, int(cb.per_block),
                                      *[v for band in cb.bands for v in band],
                                      plan.tma_epilogue]


@pytest.mark.parametrize("t,tma", [(1024, 1), (3072, 1), (1001, 0),
                                   (37, 0)])
def test_plan_picks_the_epilogue_by_t(small_net, t, tma):
    """The plan's last integer picks the epilogue from T alone: the TMA
    epilogue (residual and y by tensor maps, whose rows must be a whole 16
    bytes) where T is a multiple of 4, as the chunks of 1024 frames and
    the recipe's 3072-frame crops are, for every stage alike; the one from
    the registers at a ragged T. It is the last integer the kernel
    reads."""
    for net in (small_net, TimbreTrapNet(540, 128, 2)):
        for cb in forward_spec(net, True).convs():
            assert fl.band_tma_plan_f32(cb, t).tma_epilogue == tma
            t_pad, ints = fl._wgmma_plan_f32(cb, t, cb.band_width)
            assert len(ints) == 16 and ints[15] == tma


@pytest.mark.parametrize("kind", ["3x3-d3", "bridge"])
def test_float32_banded_conv_takes_the_twin_on_cpu(monkeypatch, kind):
    """On the CPU a float32 ``banded_conv`` hands its arguments to the
    twin and returns its result; neither launch path is reached, no
    launch count moves, and under a profiler the call is one ``tt.k1``
    span (a spy stands in for the twin)."""
    cb = _flagship_stage(kind)
    rng = np.random.default_rng(1)
    x = _rand(rng, 1, cb.r_in, 9)
    res = None if cb.per_block else _rand(rng, 1, cb.r_out, 9)
    calls, sentinel = [], object()

    def spy(*a):
        calls.append(a)
        return sentinel

    def refuse(*a):
        raise AssertionError("a CPU tensor reached a kernel launch")

    monkeypatch.setattr(fl, "banded_conv_reference", spy)
    for launch in ("_launch_wgmma_f32", "_launch_wgmma", "_launch_band"):
        monkeypatch.setattr(fl, launch, refuse)
    counts = ("launches", "mma_launches", "mma_launches_f32",
              "tma_epilogue_launches_f32")
    before = [getattr(fl.banded_conv, n) for n in counts]
    profiling.reset_record()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert fl.banded_conv(x, cb, True, res) is sentinel
    assert profiling.record()["tt.k1"]["count"] == 1
    assert len(calls) == 1
    assert all(g is w for g, w in zip(calls[0], (x, cb, True, res)))
    assert [getattr(fl.banded_conv, n) for n in counts] == before


def test_banded_conv_mma_refuses_cpu_float32():
    """The previous kernels' wrapper, kept to time and hold the new ones
    against on the card, takes CUDA tensors only, float32 too."""
    cb = _flagship_stage("bridge")
    x = torch.zeros((1, cb.r_in, 8), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA bfloat16 or float32"):
        fl.banded_conv_mma(x, cb)
