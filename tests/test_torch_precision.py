"""The port's entry points run float32 as float32 (no TF32).

PyTorch lets cuDNN run float32 convolutions in TF32 unless told otherwise.
Building the trainer or loading the serve app's generator turns TF32 off
for cuDNN and cuBLAS (``tartangan_torch/utils/precision.py``). The flags
are process-wide settings that exist on a CPU build too, so the test runs
here with ``--device cpu``.
"""
import pytest
import torch

from tartangan_torch import serve
from tartangan_torch.configs import GAN_CONFIGS
from tartangan_torch.convert import to_flax
from tartangan_torch.models import factories as F
from tartangan_torch.models.pluggan import Generator
from tartangan_torch.ops.init import init_module_
from tartangan_torch.train.cnn import CNNTrainer
from tartangan_torch.utils import msgpack


@pytest.fixture()
def tf32_on():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = saved


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def test_building_the_trainer_turns_tf32_off(tf32_on, tiny_archive,
                                             tmp_path):
    assert _tf32_flags() == (True, True)
    CNNTrainer.create_from_cli([
        tiny_archive, "--config", "16", "--batch-size", "8",
        "--output", str(tmp_path / "out"), "--run-id", "tf32",
        "--device", "cpu"])
    assert _tf32_flags() == (False, False)


def test_building_the_serve_app_turns_tf32_off(tf32_on, tmp_path):
    g = Generator(GAN_CONFIGS["16"],
                  input_factory=F.g_input_factory("mlp", "relu"),
                  block_factory=F.g_block_factory("bn", "relu"),
                  output_factory=F.g_output_factory("bn", "relu"))
    init_module_(g, torch.Generator().manual_seed(0))
    tree = to_flax(g)
    ckpt = tmp_path / "run" / "checkpoints" / "1"
    ckpt.mkdir(parents=True)
    (tmp_path / "run" / "config.args").write_text("--config\n16\n")
    (ckpt / "g.msgpack").write_bytes(msgpack.dumps(tree))
    (ckpt / "g_target.msgpack").write_bytes(
        msgpack.dumps({"params": tree["params"]}))

    assert _tf32_flags() == (True, True)
    # as serve.main builds it
    app = serve._ServeApp(serve._ServeApp.parse_cli_args(
        [str(tmp_path / "run"), "--device", "cpu"]))
    app.load_generator(target=not app.args.no_target)
    assert _tf32_flags() == (False, False)
