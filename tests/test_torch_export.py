"""The port's ONNX export against the JAX package's: the emitter byte for
byte, and its numpy interpreter against the JAX interpreter and the port's
eval-mode generator.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tartangan_tpu.configs import GAN_CONFIGS as JAX_GAN_CONFIGS
from tartangan_tpu.export import onnx as jonnx
from tartangan_tpu.export import onnx_eval as jonnx_eval
from tartangan_tpu.models import factories as JF
from tartangan_tpu.models.pluggan import Generator as JaxGenerator
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import from_flax
from tartangan_torch.export import onnx, onnx_eval
from tartangan_torch.models import factories as F
from tartangan_torch.models.pluggan import Generator


def _generators(config, g_base, activation):
    """The JAX generator with non-trivial running statistics (two
    train-mode applies, as ``tests/test_onnx_export.py`` makes them) and the
    port's on the same variables."""
    cfg = JAX_GAN_CONFIGS[config]
    jg = JaxGenerator(cfg, input_factory=JF.g_input_factory(g_base, activation),
                      block_factory=JF.g_block_factory("bn", activation),
                      output_factory=JF.g_output_factory("bn", activation))
    variables = jg.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, cfg.latent_dims)), train=True)
    z = jax.random.normal(jax.random.PRNGKey(1), (4, cfg.latent_dims))
    for _ in range(2):
        _, updates = jg.apply(variables, z, train=True,
                              mutable=["batch_stats"])
        variables = {"params": variables["params"], **updates}
    variables = jax.device_get(variables)
    g = Generator(GAN_CONFIGS[config],
                  input_factory=F.g_input_factory(g_base, activation),
                  block_factory=F.g_block_factory("bn", activation),
                  output_factory=F.g_output_factory("bn", activation))
    g.load_state_dict(from_flax(variables))
    return jg, variables, g


@pytest.mark.parametrize("config,g_base,activation", [
    ("16", "mlp", "relu"),
    ("32", "tiledz", "selu"),
    ("test128", "mlp", "relu"),   # the attention layer
])
def test_onnx_export_matches_jax(config, g_base, activation):
    """The same bytes as the JAX emitter; the port's interpreter gives the
    JAX interpreter's output exactly and the port's G in eval mode within
    1e-4."""
    jg, variables, g = _generators(config, g_base, activation)
    model_bytes = onnx.export_generator(g, batch_size=2)
    assert model_bytes == jonnx.export_generator(jg, variables, batch_size=2)
    z = np.random.default_rng(7).standard_normal(
        (2, g.config.latent_dims)).astype(np.float32)
    out = onnx_eval.evaluate(model_bytes, {"z": z})["image"]
    np.testing.assert_array_equal(
        out, jonnx_eval.evaluate(model_bytes, {"z": z})["image"])
    with torch.no_grad():
        expected = g(torch.from_numpy(z), train=False).numpy()
    np.testing.assert_allclose(out, expected, rtol=1e-4, atol=1e-4)


def test_onnx_export_rejects_the_default_block():
    g = Generator(GAN_CONFIGS["32"])
    with pytest.raises(NotImplementedError, match="GeneratorBlock"):
        onnx.export_generator(g)
