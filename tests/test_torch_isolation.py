"""The PyTorch port stands alone: no JAX, no JAX package, no CPU fallback.

``mx_rcnn_tpu_torch`` and ``chip_smoke.py`` import ``torch`` and never
``jax``, ``flax``, ``msgpack`` or ``mx_rcnn_tpu`` (the port keeps its own
copies of the jax-free modules it needs, and its own msgpack codec).  Its entry points run on the card unless the
caller names the CPU, and no kernel wrapper catches an error to fall back
to its plain version.
"""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "mx_rcnn_tpu_torch"
_FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "mx_rcnn_tpu")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    offenders = {str(p.relative_to(REPO)): sorted(
        _imported_roots(p) & set(_FORBIDDEN)) for p in _port_sources()}
    assert not {k: v for k, v in offenders.items() if v}
    assert len(offenders) >= 61


def test_importing_every_module_loads_no_jax():
    """In a fresh interpreter (this one already imported jax in
    conftest), import the package and every submodule."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import mx_rcnn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'mx_rcnn_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 59


def test_kernel_wrappers_have_no_fallback():
    """No ``try`` in the modules that dispatch between a kernel and its
    plain version: a CUDA tensor launches the kernel or the call raises."""
    for rel in ("ops/nms.py", "ops/roi_pool.py", "kernels.py"):
        tree = ast.parse((PKG / rel).read_text())
        tries = [n.lineno for n in ast.walk(tree) if isinstance(n, ast.Try)]
        if rel == "kernels.py":
            # build_all waits for every nvcc before it re-raises
            assert len(tries) <= 1, tries
        else:
            assert not tries, (rel, tries)


def test_entry_points_refuse_to_drop_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import Predictor
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.tools import demo
    from mx_rcnn_tpu_torch.tools import test as test_tool

    cfg = generate_config("tiny", "PascalVOC")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor(model, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        demo.main(["--synthetic", "1", "--network", "tiny"])
    # the eval entry point refuses before it reads any checkpoint
    with pytest.raises(RuntimeError, match="CUDA"):
        test_tool.main(["--synthetic", "1", "--network", "tiny",
                        "--prefix", "/nonexistent/e2e", "--epoch", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        test_tool.test_rcnn(cfg, prefix="/nonexistent/e2e", epoch=1,
                            synthetic=1)
    assert Predictor(model, cfg, device="cpu").device.type == "cpu"


def test_training_entry_points_refuse_to_drop_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.train import setup_training
    from mx_rcnn_tpu_torch.tools import train

    cfg = generate_config("tiny", "synthetic")
    with pytest.raises(RuntimeError, match="CUDA"):
        setup_training(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--synthetic", "2", "--network", "tiny", "--dataset",
                    "synthetic", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--synthetic", "2", "--network", "tiny", "--dataset",
                    "synthetic", "--prefix", "/nonexistent/e2e",
                    "--end_epoch", "1", "--resume"])
    state = setup_training(cfg, device="cpu")
    assert next(state.model.parameters()).device.type == "cpu"
    assert state.model.training and state.step == 0


def test_alternate_schedule_entry_points_refuse_to_drop_to_the_cpu():
    """``train_net``, the five stage tools, ``generate_proposals`` and
    ``test_rcnn_stage`` raise without a card unless asked for the CPU,
    before they read a checkpoint or a pickle."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.core.tester import generate_proposals
    from mx_rcnn_tpu_torch.models.faster_rcnn import build_model
    from mx_rcnn_tpu_torch.tools import (test_rcnn, test_rpn,
                                         train_alternate, train_rcnn,
                                         train_rpn)
    from mx_rcnn_tpu_torch.tools.train import train_net

    cfg = generate_config("tiny", "synthetic")
    common = ["--synthetic", "2", "--network", "tiny", "--dataset",
              "synthetic"]
    missing = ["--prefix", "/nonexistent/m", "--epoch", "1"]
    calls = [
        lambda: train_net(cfg, mode="rpn", synthetic=2),
        lambda: train_rpn.main(common),
        lambda: train_rcnn.main(common + ["--proposals", "/nonexistent.pkl"]),
        lambda: test_rpn.main(common + missing + ["--out", "/nonexistent"]),
        lambda: test_rcnn.main(common + missing + [
            "--proposals", "/nonexistent.pkl"]),
        lambda: test_rcnn.test_rcnn_stage(cfg, prefix="/nonexistent/m",
                                          epoch=1, proposals=[],
                                          synthetic=1),
        lambda: train_alternate.main(common + ["--prefix", "/nonexistent/m"]),
        lambda: generate_proposals(build_model(cfg, "cpu"), [], cfg),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    """``chip_smoke.py`` exits non-zero and prints no result line when
    there is no CUDA device, in the repo and alone in a directory."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = REPO / "chip_smoke.py"
    if alone:
        script = tmp_path / script.name
        script.write_bytes((REPO / "chip_smoke.py").read_bytes())
    out = subprocess.run([sys.executable, str(script)],
                         cwd=script.parent, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


_OBS_MODULES = sorted(
    [p for p in (PKG / "obs").glob("*.py")]
    + [p for p in (PKG / "analysis").glob("*.py")]
    + [PKG / "tools" / "obs_smoke.py"])


@pytest.mark.parametrize("path", _OBS_MODULES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_observability_modules_stand_alone(path):
    """Each module of the observability plane and the lock sanitizer
    imports nothing of JAX or the JAX package, and is among the modules
    the fresh-interpreter import test loads."""
    assert not _imported_roots(path) & set(_FORBIDDEN)
    assert path in _port_sources()


def test_observability_plane_imports_without_jax_or_torch():
    """The plane's host modules load neither JAX nor torch (the
    profiler imports torch only when a window opens)."""
    code = (
        "import sys\n"
        "import importlib\n"
        "for m in ('metrics', 'trace', 'timeseries', 'health', 'flightrec',"
        " 'collect', 'runrec', 'profiler'):\n"
        "    importlib.import_module('mx_rcnn_tpu_torch.obs.' + m)\n"
        "import mx_rcnn_tpu_torch.analysis.sanitizer\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{_FORBIDDEN + ('torch',)!r})\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_FLEET_MODULES = [PKG / rel for rel in (
    "serve/fleet.py", "ft/supervisor.py", "tools/fleet.py", "tools/bulk.py",
    "tools/loadgen.py", "obs/collect.py")]


@pytest.mark.parametrize("path", _FLEET_MODULES,
                         ids=lambda p: str(p.relative_to(PKG)))
def test_fleet_modules_stand_alone(path):
    """The serving fleet, its restart policy, its CLIs and the fleet
    collector import nothing of JAX or the JAX package, and are among
    the modules the fresh-interpreter import test loads."""
    assert not _imported_roots(path) & set(_FORBIDDEN)
    assert path in _port_sources()


def test_fleet_entry_points_refuse_to_drop_to_the_cpu(tmp_path):
    """The fleet's CLIs and ``build_fleet`` raise without a card unless
    asked for the CPU, before they read or write anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from mx_rcnn_tpu_torch.config import generate_config
    from mx_rcnn_tpu_torch.serve.fleet import build_fleet, default_devices
    from mx_rcnn_tpu_torch.tools import bulk, fleet, loadgen

    missing = str(tmp_path / "nonexistent")
    calls = [
        lambda: fleet.main(["export", "--out", missing]),
        lambda: fleet.main(["serve", "--port", "0"]),
        lambda: fleet.main(["join_bench", "--mode", "trace"]),
        lambda: fleet.main(["join_bench", "--mode", "export",
                            "--export_dir", missing]),
        lambda: bulk.main(["--workdir", str(tmp_path / "w"),
                           "--root_path", missing]),
        lambda: bulk.main(["--protocol", "kill_resume", "--workdir",
                           str(tmp_path / "w"), "--root_path", missing]),
        lambda: loadgen.main(["--smoke", "--fleet", "2"]),
        lambda: loadgen.main(["--fleet_smoke", "--workdir",
                              str(tmp_path / "fb")]),
        lambda: build_fleet(generate_config("tiny", "synthetic"), {}),
        lambda: default_devices(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not (tmp_path / "nonexistent").exists()
    assert default_devices("cpu") == [torch.device("cpu")]


def test_obs_smoke_refuses_to_drop_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    from mx_rcnn_tpu_torch.tools import obs_smoke

    with pytest.raises(RuntimeError, match="CUDA"):
        obs_smoke.main(["--workdir", str(tmp_path)])
