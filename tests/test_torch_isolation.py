"""The port stands alone: no module of ``src/repro_torch``, not
``chip_smoke.py`` and not the card's tests import JAX or the JAX package,
and importing the engine loads no JAX."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py",
    ROOT / "tests" / "test_torch_gpu.py",  # runs where JAX is not installed
    ROOT / "examples" / "torch_quickstart.py",
    ROOT / "examples" / "torch_count_distributed.py",
    ROOT / "examples" / "torch_train_lm.py",
    ROOT / "tools" / "torch_render_experiments.py",
    ROOT / "tools" / "torch_flash_fp32.py",  # runs on the card
]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


NEW_MODULES = ["api", "core/prng.py", "core/supervisor.py", "train/checkpoint.py",
               "testing/faults.py", "kernels/spmm_block.py"]


@pytest.mark.parametrize("module", NEW_MODULES)
def test_slice_two_modules_are_checked(module):
    """The modules slice 2 added are among the files the import check reads."""
    path = ROOT / "src" / "repro_torch" / (module if module.endswith(".py") else module + ".py")
    assert path in PORT_FILES


SLICE_THREE_MODULES = ["configs/__init__.py", "configs/base.py", "configs/granite_3_8b.py",
                       "configs/internlm2_1_8b.py", "configs/qwen1_5_0_5b.py",
                       "configs/smollm_360m.py", "kernels/flash_attention.py",
                       "models/__init__.py", "models/layers.py", "models/attention.py",
                       "models/transformer.py", "models/factory.py", "models/convert.py",
                       "testing/numerics.py"]


@pytest.mark.parametrize("module", SLICE_THREE_MODULES)
def test_slice_three_modules_are_checked(module):
    """The LM slice's modules are among the files the import check reads."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


SLICE_EIGHT_MODULES = ["core/frontier.py"]


@pytest.mark.parametrize("module", SLICE_EIGHT_MODULES)
def test_slice_eight_modules_are_checked(module):
    """The compaction slice's module is among the files the import check reads."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


SLICE_NINE_MODULES = ["comm/__init__.py", "comm/group.py", "comm/ring.py", "comm/pipelined.py",
                      "comm/adaptive.py", "launch/mesh.py", "core/distributed.py"]


@pytest.mark.parametrize("module", SLICE_NINE_MODULES)
def test_slice_nine_modules_are_checked(module):
    """The distributed slice's modules are among the files the import check reads."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


SLICE_ELEVEN_MODULES = ["serve/__init__.py", "serve/counting_service.py", "launch/serve.py"]


@pytest.mark.parametrize("module", SLICE_ELEVEN_MODULES)
def test_slice_eleven_modules_are_checked(module):
    """The counting service's modules are among the files the import check reads."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


SLICE_TWELVE_MODULES = ["comm/abstract.py", "kernels/work.py", "launch/dryrun.py",
                        "roofline/__init__.py", "roofline/analysis.py"]


@pytest.mark.parametrize("module", SLICE_TWELVE_MODULES)
def test_slice_twelve_modules_are_checked(module):
    """The dry-run slice's modules are among the files the import check reads."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


SLICE_THIRTEEN_MODULES = ["configs/llama3_2_vision_90b.py", "configs/whisper_base.py",
                          "configs/phi3_5_moe.py", "configs/mixtral_8x22b.py",
                          "configs/rwkv6_3b.py", "configs/recurrentgemma_2b.py", "models/moe.py",
                          "models/rwkv6.py", "models/rglru.py"]


@pytest.mark.parametrize("module", SLICE_THIRTEEN_MODULES)
def test_slice_thirteen_modules_are_checked(module):
    """The modules of the six remaining rows are among the files the import
    check reads."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


SLICE_FOURTEEN_MODULES = ["train/__init__.py", "train/optimizer.py", "train/data.py",
                          "train/train_loop.py", "launch/train.py"]


@pytest.mark.parametrize("module", SLICE_FOURTEEN_MODULES)
def test_slice_fourteen_modules_are_checked(module):
    """The training slice's modules are among the files the import check reads."""
    assert ROOT / "src" / "repro_torch" / module in PORT_FILES


def test_engine_import_loads_no_jax():
    code = (
        "import sys, repro_torch.core.count_engine, repro_torch.core.estimator, "
        "repro_torch.core.prng, repro_torch.core.supervisor, repro_torch.api, "
        "repro_torch.train.checkpoint, repro_torch.testing.faults, "
        "repro_torch.kernels.spmm_block, repro_torch.launch.count, repro_torch.configs, "
        "repro_torch.configs.base, repro_torch.kernels.flash_attention, repro_torch.models, "
        "repro_torch.models.layers, repro_torch.models.attention, "
        "repro_torch.models.transformer, repro_torch.models.factory, "
        "repro_torch.models.convert, repro_torch.testing.numerics, repro_torch.core.frontier, "
        "repro_torch.comm, repro_torch.comm.group, repro_torch.comm.ring, "
        "repro_torch.comm.pipelined, repro_torch.comm.adaptive, repro_torch.launch.mesh, "
        "repro_torch.core.distributed, repro_torch.serve, repro_torch.launch.serve, "
        "repro_torch.comm.abstract, repro_torch.kernels.work, repro_torch.launch.dryrun, "
        "repro_torch.roofline, repro_torch.roofline.analysis, repro_torch.models.moe, "
        "repro_torch.models.rwkv6, repro_torch.models.rglru, repro_torch.train, "
        "repro_torch.train.optimizer, repro_torch.train.data, repro_torch.train.train_loop, "
        "repro_torch.launch.train; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Alone in a directory, or without CUDA, it fails and prints no result."""
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, str(lone)], capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
