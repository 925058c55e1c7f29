"""The extension-field NTT `ntt_ext` against the JAX package: babybear4
forward and inverse with a batch against JAX `ntt_ext`, and goldilocks2
(whose limb base JAX `ntt_ext` refuses) against JAX `ntt_jit` component by
component, element for element (tolerance 0), from numpy seeds. Each
component goes through `ntt` as its own vector, the route that sends a
large babybear4 NTT on the card to two `dif_rows` launches a component."""

import numpy as np
import pytest
import torch

from icicle_tpu.fields import extension as JE
from icicle_tpu.ops import ntt as JN
from icicle_tpu.runtime.config import NTTDir as JDir
from icicle_tpu_torch.fields import extension as TE
from icicle_tpu_torch.ops import ntt as TN
from icicle_tpu_torch.runtime import device, dispatcher
from icicle_tpu_torch.runtime.config import NTTDir


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setattr(device, "_device", torch.device("cpu"))


def _same(j, t: torch.Tensor) -> None:
    assert np.array_equal(np.asarray(j).view(np.int32), t.numpy())


def test_babybear4_matches_jax_with_a_batch():
    jf, tf = JE.get_ext_field("babybear"), TE.get_ext_field("babybear")
    x_t = tf.rand(np.random.default_rng(1), (2, 64), "cpu")       # (batch, n, D)
    x_j = np.asarray(x_t.numpy().view(np.uint32))
    y_t = TN.ntt_ext(tf, x_t, NTTDir.FORWARD)
    _same(JN.ntt_ext(jf, x_j, JDir.FORWARD), y_t)
    z_t = TN.ntt_ext(tf, y_t, NTTDir.INVERSE)
    _same(JN.ntt_ext(jf, np.asarray(y_t.numpy().view(np.uint32)), JDir.INVERSE), z_t)
    assert torch.equal(z_t, x_t)


def test_goldilocks2_matches_jax_componentwise():
    jf = JE.get_ext_field("goldilocks")
    tf = TE.get_ext_field("goldilocks")
    x_t = tf.rand(np.random.default_rng(2), (3, 32), "cpu")       # (batch, n, 2 * 2)
    x_j = np.asarray(x_t.numpy().view(np.uint32))
    for direction, jdir in ((NTTDir.FORWARD, JDir.FORWARD), (NTTDir.INVERSE, JDir.INVERSE)):
        y_t = TN.ntt_ext(tf, x_t, direction)
        want = np.concatenate([np.asarray(JN.ntt_jit(jf.base, x_j[..., 2 * i:2 * i + 2], jdir))
                               for i in range(2)], -1)
        _same(want, y_t)
    assert torch.equal(TN.ntt_ext(tf, TN.ntt_ext(tf, x_t, NTTDir.FORWARD), NTTDir.INVERSE), x_t)


def test_each_component_is_its_own_vector(monkeypatch):
    """ntt_ext calls `ntt` once a component, on a contiguous (n,) vector for
    a single vector over a single-word base (what `_ntt_cuda` takes to
    `dif_rows`), and is registered under the JAX registry's name."""
    tf = TE.get_ext_field("koalabear")
    seen = []
    real = TN.ntt

    def spy(f, x, dir=NTTDir.FORWARD, cfg=TN._DEFAULT):
        seen.append((f.name, tuple(x.shape), x.is_contiguous()))
        return real(f, x, dir, cfg)

    monkeypatch.setattr(TN, "ntt", spy)
    x = tf.rand(np.random.default_rng(3), (16,), "cpu")
    TN.ntt_ext(tf, x)
    assert seen == [("koalabear", (16,), True)] * 4
    assert dispatcher.dispatch("extension_ntt", None, x) is TN.ntt_ext
