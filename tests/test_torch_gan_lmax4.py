"""The lmax-4 model case (the lmax of configs/gan_recipe.yml): the GAN
generator's ``sequence_logp`` with the grammar mask, from
``encode_pocket``'s output on two val complexes' own SMILES, value and
gradient in every generator parameter, against the JAX package at
``singa_params(4, 2)`` (gate FFN, 25 coefficients). CPU, float32; a file of
its own, so that its JAX compile runs beside the other files'.

Tolerances as tests/test_torch_gan_logp.py: the log-probs to 1e-5
relative, gradients by ``close_grads`` (1e-4 of each leaf's largest
magnitude, floored at 1e-3 of the model's largest).
"""
from __future__ import annotations

import numpy as np

from test_torch_common import close_grads, logp_vs_jax


def test_sequence_logp_and_gradient_match_jax_at_lmax4():
    (jlp, jgrads), (lp, grads) = logp_vs_jax(4, True)
    assert np.isfinite(jlp).all() and (jlp < 0).all()
    np.testing.assert_allclose(lp.numpy(), jlp, rtol=1e-5)
    close_grads(grads, jgrads)
    # the gate FFN's weights at 25 coefficients (kernel K2b's gradient) take part
    ffn = [n for n in grads if n.startswith("embedding.block_") and ".ffn.w" in n]
    assert ffn and all(float(grads[n].abs().max()) > 0 for n in ffn)
