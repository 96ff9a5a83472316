"""The port's interop (timbre_trap_tpu_torch.interop) against the JAX
package's ``interop/torch_import.py`` on the same parameter trees, on the
CPU at the small geometry (8 kHz, 5 octaves x 12 bins, latent 16,
complexity 1), for the base model and FiLM with skip connections (the
linear FiLM kernels and the flat ``skip_weights``):

* ``export_torch_state_dict`` key for key and bit for bit, with and without
  ``like`` (the port net's ``.0`` names);
* ``import_torch_state_dict`` of either export bit for bit, and the round
  trip;
* the missing-key and shape-mismatch refusals, with ``_validate``'s message;
* ``load_torch_checkpoint`` of a bare state_dict save and of a whole-module
  save (``torch.save(net)``);
* ``state_dict_from_jax`` and ``hwio_params``, rebuilt on the one layout
  table, against the net's own parameters.
"""

import numpy as np
import pytest
import torch

import jax

from timbre_trap_tpu.interop import \
    export_torch_state_dict as jax_export_torch_state_dict
from timbre_trap_tpu.interop import \
    import_torch_state_dict as jax_import_torch_state_dict
from timbre_trap_tpu.interop import \
    load_torch_checkpoint as jax_load_torch_checkpoint
from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu.models import TimbreTrapFiLM as JaxTimbreTrapFiLM
from timbre_trap_tpu_torch.interop import (_flatten, export_torch_state_dict,
                                           hwio_params,
                                           import_torch_state_dict,
                                           load_torch_checkpoint,
                                           state_dict_from_jax)
from timbre_trap_tpu_torch.models import TimbreTrap, TimbreTrapFiLM

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
FAMILIES = {"base": (JaxTimbreTrap, TimbreTrap, False),
            "film+skips": (JaxTimbreTrapFiLM, TimbreTrapFiLM, True)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def pair(request):
    """(JAX parameter tree as numpy, the port model holding the same
    weights)."""
    jax_cls, cls, skips = FAMILIES[request.param]
    params = jax.tree.map(np.asarray, jax_cls(
        **HP, skip_connections=skips, seed=3).params)
    model = cls(**HP, skip_connections=skips, device="cpu")
    model.load_jax_params(params)
    return params, model


def _assert_same_dict(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def _assert_same_tree(got, want):
    got, want = _flatten(got), _flatten(want)
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=str(key))


@pytest.mark.parametrize("with_like", [False, True])
def test_export_matches_jax(pair, with_like):
    params, model = pair
    like = list(model.net.state_dict()) if with_like else None
    got = export_torch_state_dict(params, like=like)
    _assert_same_dict(got, jax_export_torch_state_dict(params, like=like))
    if with_like:
        assert set(got) == set(model.net.state_dict())


@pytest.mark.parametrize("with_like", [False, True])
def test_import_matches_jax(pair, with_like):
    params, model = pair
    like = list(model.net.state_dict()) if with_like else None
    state_dict = jax_export_torch_state_dict(params, like=like)
    got = import_torch_state_dict(state_dict, hwio_params(model.net))
    _assert_same_tree(got, jax_import_torch_state_dict(state_dict, params))
    _assert_same_tree(got, params)


def test_round_trip(pair):
    params, model = pair
    _assert_same_tree(import_torch_state_dict(export_torch_state_dict(params)),
                      params)
    # The port net's own state_dict (tensors, ``.0`` names) imports to the
    # same tree, and state_dict_from_jax gives the net's state_dict back.
    _assert_same_tree(import_torch_state_dict(model.net.state_dict()),
                      params)
    want = model.net.state_dict()
    got = state_dict_from_jax(params)
    assert set(got) == set(want)
    for key, value in want.items():
        assert torch.equal(got[key], value), key
    _assert_same_tree(jax.tree.map(lambda v: v.detach().numpy(),
                                   hwio_params(model.net)), params)


def _refusal(fn, *args):
    with pytest.raises(ValueError) as info:
        fn(*args)
    return str(info.value)


def test_refusals_match_jax(pair):
    params, model = pair
    reference = hwio_params(model.net)
    state_dict = jax_export_torch_state_dict(params)

    missing = dict(state_dict)
    del missing["encoder.convin.weight"]
    message = _refusal(import_torch_state_dict, missing, reference)
    assert message.startswith("parameter mismatch: missing=")
    assert message == _refusal(jax_import_torch_state_dict, missing, params)

    extra = dict(state_dict, **{"encoder.extra.bias": np.zeros(3, np.float32)})
    message = _refusal(import_torch_state_dict, extra, reference)
    assert "extra=[('encoder', 'extra', 'bias')]" in message
    assert message == _refusal(jax_import_torch_state_dict, extra, params)

    misshapen = dict(state_dict)
    misshapen["encoder.convin.bias"] = np.zeros(7, np.float32)
    message = _refusal(import_torch_state_dict, misshapen, reference)
    assert message.startswith("shape mismatch at encoder.convin.bias")
    assert message == _refusal(jax_import_torch_state_dict, misshapen, params)


@pytest.mark.parametrize("kind", ["state_dict", "module"])
def test_load_torch_checkpoint(pair, tmp_path, kind):
    _, model = pair
    path = str(tmp_path / "ckpt.pt")
    torch.save(model.net.state_dict() if kind == "state_dict" else model.net,
               path)
    got = load_torch_checkpoint(path)
    _assert_same_dict(got, jax_load_torch_checkpoint(path))
    want = model.net.state_dict()
    assert list(got) == list(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key], value.numpy(), err_msg=key)
