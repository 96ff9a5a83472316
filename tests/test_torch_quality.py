"""The port's quality probe (timbre_trap_tpu_torch.eval.quality) against the
JAX package's ``eval/quality.py``, on the CPU at the small geometry (8 kHz,
5 octaves x 12 bins, 0.5-s blocks, latent 16, complexity 1):

* ``synthesize_polyphony`` equal to the JAX one bit for bit (audio,
  targets, pitches), at the small geometry and at 22.05 kHz;
* ``quality_f1(steps=1, lr=0.0, n_tracks=4, conv_backend="flax")`` on the
  same weights (both models with ``remat``, so both train the caller's
  weights; the port's transcription chain in float32, the precision the
  JAX package runs on the CPU): the same F1 within 1e-6;
* port only, the case of ``tests/test_eval.py``: 40 ``"flax"`` steps (a
  remat twin) learn (F1 > 0.2) and leave the caller's parameters as they
  were;
* ``models.flax_init.jax_package_params``, the JAX package's seeded
  weights drawn without JAX (the starting point of ``chip_smoke.py``'s
  probes), against the JAX package's init: within 4 float32 units in the
  last place, at least 97 % bit for bit.

The flagship probes of ``bench.py`` (``"pallas_bf16"``, consistency off
and on) run on the card in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax

from timbre_trap_tpu.eval import quality_f1 as jax_quality_f1
from timbre_trap_tpu.eval import synthesize_polyphony as jax_synthesize
from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu.transform import CQT as JaxCQT
from timbre_trap_tpu_torch.eval import quality_f1, synthesize_polyphony
from timbre_trap_tpu_torch.models import TimbreTrap
from timbre_trap_tpu_torch.transform import CQT

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)


@pytest.mark.parametrize("geometry", [(8000, 5, 12, 0.5), (22050, 6, 12, 1)])
def test_synthesize_polyphony_matches_jax(geometry):
    sr, n_oct, bpo, secs = geometry
    kw = dict(n_octaves=n_oct, bins_per_octave=bpo, sample_rate=sr,
              secs_per_block=secs)
    got = synthesize_polyphony(CQT(**kw, device="cpu"), 5, seed=7)
    want = jax_synthesize(JaxCQT(**kw), 5, seed=7)
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        np.testing.assert_array_equal(g, w)


def test_quality_f1_matches_jax():
    jax_model = JaxTimbreTrap(**HP, seed=5, remat=True)
    model = TimbreTrap(**HP, remat=True, fused="f32", device="cpu")
    model.load_jax_params(jax.tree.map(np.asarray, jax_model.params))
    kw = dict(n_tracks=4, steps=1, lr=0.0, seed=0, conv_backend="flax")
    want = jax_quality_f1(jax_model, **kw)
    got = quality_f1(model, **kw)
    assert 0.0 <= got <= 1.0
    assert abs(got - want) <= 1e-6, (got, want)


def _snapshot(model):
    return {k: (v, v.detach().clone())
            for k, v in model.net.state_dict(keep_vars=True).items()}


def _assert_untouched(model, snapshot):
    for name, p in model.net.state_dict(keep_vars=True).items():
        obj, value = snapshot[name]
        assert p is obj and torch.equal(p.detach(), value), name
        assert p.grad is None, name


def test_quality_f1_learns():
    """The tracked metric is computable and shows learning; the caller's
    model (no remat: the "flax" backend trains a remat twin) is left as it
    was."""
    model = TimbreTrap(**HP, fused="f32", device="cpu")
    snapshot = _snapshot(model)
    f1 = quality_f1(model, n_tracks=4, steps=40, lr=2e-3, seed=0)
    _assert_untouched(model, snapshot)
    assert 0.0 <= f1 <= 1.0
    assert f1 > 0.2, f"synthetic-polyphony F1 did not rise ({f1})"




@pytest.mark.parametrize("family,seed", [("base", 0), ("film+skips", 3)])
def test_jax_package_params_match_jax_init(family, seed):
    """``models.flax_init`` draws the JAX package's seeded weights without
    JAX: the keys and bits exactly, every weight within 4 float32 units in
    the last place of JAX's and at least 97 % of them bit for bit (numpy's
    log1p rounds apart from XLA's in the rest)."""
    from timbre_trap_tpu.models import TimbreTrapFiLM as JaxTimbreTrapFiLM
    from timbre_trap_tpu_torch.interop import _flatten, hwio_params
    from timbre_trap_tpu_torch.models import TimbreTrapFiLM
    from timbre_trap_tpu_torch.models.flax_init import jax_package_params

    jax_cls, cls = {"base": (JaxTimbreTrap, TimbreTrap),
                    "film+skips": (JaxTimbreTrapFiLM, TimbreTrapFiLM)}[family]
    skips = family.endswith("skips")
    want = _flatten(jax.tree.map(np.asarray, jax_cls(
        **HP, skip_connections=skips, seed=seed).params))
    got = _flatten(jax_package_params(hwio_params(
        cls(**HP, skip_connections=skips, device="cpu").net), seed))
    assert set(got) == set(want)
    same = total = 0
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, key
        ulps = np.abs(g.view(np.int32).astype(np.int64)
                      - w.view(np.int32).astype(np.int64))
        assert ulps.max() <= 4, (key, ulps.max())
        same += int((ulps == 0).sum())
        total += ulps.size
    assert same >= 0.97 * total, same / total
