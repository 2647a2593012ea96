"""The PyTorch port's foundation: the device rules, the env registry,
initializers and mode flags, and the rule that the port (and
chip_smoke.py) imports nothing of JAX or of the JAX package.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mxnet_tpu_torch import autograd, base, device, env, initializer

ROOT = Path(__file__).resolve().parent.parent


def test_devices():
    assert device.cpu() == torch.device("cpu")
    assert device.gpu(1) == torch.device("cuda", 1)
    with pytest.raises(base.MXNetError):
        device.tpu()
    if torch.cuda.is_available():
        assert device.default_device() == torch.device("cuda", 0)
    else:
        with pytest.raises(base.MXNetError, match="CUDA"):
            device.default_device()


def test_env_registry_reads_typed_values(monkeypatch):
    assert env.get("MXTPU_FLASH_ATTENTION") is True
    monkeypatch.setenv("MXTPU_FLASH_ATTENTION", "0")
    monkeypatch.setenv("MXTPU_SERVE_MAX_BATCH", "8")
    assert env.get("MXTPU_FLASH_ATTENTION") is False
    assert env.get("MXTPU_SERVE_MAX_BATCH") == 8
    assert "MXTPU_SERVE_DRAIN_MS" in env.doc()


def test_initializers_are_seeded_and_device_independent():
    def draw(init):
        return init.init_tensor((4, 5), torch.float32, torch.device("cpu"),
                                torch.Generator().manual_seed(3))

    u = draw(initializer.Uniform())
    assert torch.equal(u, draw(initializer.create("uniform")))
    assert u.abs().max() <= 0.07
    assert torch.equal(draw(initializer.create("zeros")),
                       torch.zeros(4, 5))
    assert torch.equal(draw(initializer.One()), torch.ones(4, 5))
    assert draw(initializer.Normal(0.5)).std() > 0.2


def test_mode_flags_are_scoped():
    assert not autograd.is_training() and not autograd.is_recording()
    with autograd.record():
        assert autograd.is_training() and autograd.is_recording()
        with autograd.pause():
            assert not autograd.is_training()
            assert not autograd.is_recording()
    with autograd.train_mode():
        assert autograd.is_training()
        with autograd.predict_mode():
            assert not autograd.is_training()
    assert not autograd.is_training()


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|mxnet_tpu)(?![\w])"
    r"|import_module\(\s*['\"](?:jax|mxnet_tpu)['\".]"
    r"|__import__\(\s*['\"](?:jax|mxnet_tpu)['\".]", re.M)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "mxnet_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in _FORBIDDEN.finditer(f.read_text())]
    assert offenders == []


def test_every_kernel_source_has_a_wrapper_a_counter_and_a_plain_version():
    """Every csrc/*.cu is the source of at least one row of chip_smoke.py's
    kernel table (which becomes its ``kernels`` line); each row names a
    wrapper and a plain version that exist in one module, a launch counter
    that the wrapper's module registers, and the TPU kernel it replaces
    (the optimizer's global-norm pre-pass: the reference's jitted XLA
    norm, which no Pallas kernel computes; the ring's hop kernels: the
    reference's ring forward and backward, which run the Pallas attention
    kernels on each hop; the INT8 kernels: the reference's XLA quantize and
    int8 convolution)."""
    import importlib

    sys.path.insert(0, str(ROOT))
    try:
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    from mxnet_tpu_torch.kernels import build

    def resolve(spec):
        mod, _, attr = spec.partition(":")
        obj = importlib.import_module(mod)
        for part in attr.split("."):
            obj = getattr(obj, part)
        return obj

    sources = sorted(str(p.relative_to(ROOT))
                     for p in (ROOT / "mxnet_tpu_torch/csrc").glob("*.cu"))
    assert len(sources) == 9
    assert sorted({k["source"] for k in chip_smoke.KERNELS
                   if "/csrc/" in k["source"]}) == sources
    # the runtime-compiled kernels (K7) come from user sources through rtc
    assert [k["source"] for k in chip_smoke.KERNELS
            if "/csrc/" not in k["source"]] == ["mxnet_tpu_torch/rtc.py"]
    for k in chip_smoke.KERNELS:
        assert k["route"] in ("cuda", "triton")
        assert callable(resolve(k["wrapper"])) and callable(
            resolve(k["plain"]))
        assert resolve(k["wrapper"]).__module__ == \
            resolve(k["plain"]).__module__
        assert isinstance(build.COUNTERS[k["name"]], build.LaunchCounter)
        ref_file, _, line = k["replaces"].partition(":")
        text = (ROOT / ref_file).read_text().splitlines()
        if k["name"] == "opt_sqnorm":
            assert "def _fused_norm_jitted(" in text[int(line) - 1]
            continue
        if k["name"] in ("ring_flash_fwd", "ring_flash_bwd"):
            assert text[int(line) - 1].startswith(
                ("def _ring_flash_fwd_impl(", "def _ring_flash_vjp_bwd(")), \
                k["replaces"]
            continue
        if k["name"].startswith("int8_"):
            assert text[int(line) - 1].lstrip().startswith(
                ("def _q(", "acc = jax.lax.conv_general_dilated(")), \
                k["replaces"]
            continue
        assert ("_kernel(" in text[int(line) - 1]
                or "pallas_call(" in text[int(line) - 1]), k["replaces"]
    # the sources share the dropout hash through one header
    for name in ("flash_attention_fwd.cu", "flash_attention_bwd.cu"):
        src = (ROOT / "mxnet_tpu_torch/csrc" / name).read_text()
        assert '#include "flash_attention_common.cuh"' in src
        assert "0x9E3779B1" not in src


def test_port_imports_with_jax_unavailable():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'mxnet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import mxnet_tpu_torch, mxnet_tpu_torch.serving, "
            "mxnet_tpu_torch.convert\n"
            "import mxnet_tpu_torch.gluon.model_zoo.bert\n"
            "import mxnet_tpu_torch.ops.flash_attention\n"
            "import importlib, pathlib\n"
            "root = pathlib.Path('mxnet_tpu_torch')\n"
            "mods = sorted('.'.join(p.with_suffix('').parts) "
            "for p in root.rglob('*.py') if p.name != '__init__.py')\n"
            "assert len(mods) > 25, mods\n"
            "for m in mods:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n")
    env_ = dict(os.environ, PYTHONPATH=str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=env_, timeout=120)


SLICE4_MODULES = ["mxnet_tpu_torch/ndarray/__init__.py",
                  "mxnet_tpu_torch/ndarray/ndarray.py",
                  "mxnet_tpu_torch/ndarray/random.py",
                  "mxnet_tpu_torch/ndarray/utils.py",
                  "mxnet_tpu_torch/numpy/__init__.py",
                  "mxnet_tpu_torch/numpy/multiarray.py",
                  "mxnet_tpu_torch/numpy/random.py",
                  "mxnet_tpu_torch/numpy_extension/__init__.py",
                  "mxnet_tpu_torch/ops/registry.py",
                  "mxnet_tpu_torch/ops/tensor.py",
                  "mxnet_tpu_torch/_random.py", "mxnet_tpu_torch/rtc.py",
                  "mxnet_tpu_torch/gluon/model_zoo/vision/lenet.py",
                  "mxnet_tpu_torch/tools/train_lenet.py"]


def test_ndarray_frontend_modules_import_no_jax():
    """The NDArray frontend, rtc and LeNet import neither JAX nor the JAX
    package, by their text and when JAX cannot be imported at all."""
    offenders = [f"{f}: {m.group(0).strip()}" for f in SLICE4_MODULES
                 for m in _FORBIDDEN.finditer((ROOT / f).read_text())]
    assert offenders == []
    mods = [f[:-3].replace("/", ".").removesuffix(".__init__")
            for f in SLICE4_MODULES]
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'mxnet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import mxnet_tpu_torch as mx\n"
            "assert mx.np.zeros and mx.nd.zeros and mx.rtc.CudaModule\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=str(ROOT)), timeout=120)


def test_creation_without_a_device_needs_a_card():
    """mx.np.array with no device and no scope lands on cuda:0, and raises
    where there is no card, instead of landing on the CPU."""
    import mxnet_tpu_torch as mx

    if torch.cuda.is_available():
        assert mx.np.array([1.0]).device == torch.device("cuda", 0)
        return
    for make in (lambda: mx.np.array([1.0, 2.0]), lambda: mx.np.zeros((2,)),
                 lambda: mx.np.random.uniform(size=(2,)),
                 lambda: mx.nd.array([1.0])):
        with pytest.raises(base.MXNetError, match="CUDA"):
            make()
    with mx.cpu():
        assert mx.np.array([1.0]).device == torch.device("cpu")
        assert mx.current_device() == torch.device("cpu")
    with pytest.raises(base.MXNetError, match="CUDA"):
        mx.current_device()
