"""The GAN generator's log-probs against the JAX package at the tiny config
(lmax 2, gate FFN): ``sequence_logp`` from ``encode_pocket``'s output on
two val complexes' own SMILES (SOS first, EOS inside, PAD after), with the
grammar mask off and on, value and gradient in every generator parameter.
CPU, float32. The lmax-4 case is tests/test_torch_gan_lmax4.py.

Tolerances: the log-probs to 1e-5 relative (sums of ~20 log-softmax terms
of LayerNorm'd float32 stacks); gradients leaf by leaf to 1e-4 of the
leaf's largest magnitude, floored at 1e-3 of the model's largest
(``close_grads``).
"""
from __future__ import annotations

import numpy as np
import pytest

from test_torch_common import close_grads, logp_vs_jax


@pytest.mark.parametrize("grammar_mask", [False, True], ids=["mask_off", "mask_on"])
def test_sequence_logp_and_gradient_match_jax(grammar_mask):
    (jlp, jgrads), (lp, grads) = logp_vs_jax(2, grammar_mask)
    assert np.isfinite(jlp).all() and (jlp < 0).all()
    np.testing.assert_allclose(lp.numpy(), jlp, rtol=1e-5)
    close_grads(grads, jgrads)
    assert any(float(g.abs().max()) > 0 for n, g in grads.items() if n.startswith("embedding."))
