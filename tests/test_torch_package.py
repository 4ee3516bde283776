"""The port stands alone: no file of src/repro_torch, and not chip_smoke.py,
imports `jax` or the JAX package `repro` (the SSM and classifier slices'
modules named among them); its entry points run on CUDA
unless told otherwise and raise without it; its CLI serves every flag of
JAX's (the M_L backends' flags: see tests/test_torch_remote.py; the
ladder's: tests/test_torch_cascade_ladder.py) and refuses by name only
the archs the engine does not take; chip_smoke.py refuses to run without
a card or outside a checkout."""
import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}
# modules of the training slice and of the deferral / prefill slice, named
# so that the checks below cannot pass by missing them
TRAINING_MODULES = ("core.gatekeeper", "data.pipeline",
                    "kernels.gatekeeper_loss", "launch.steps",
                    "launch.train", "training.checkpoint", "training.loop",
                    "training.optim")
SIGNAL_MODULES = ("core.baselines", "core.cascade", "core.deferral",
                  "core.metrics", "kernels.deferral_entropy",
                  "kernels.flash_attention", "kernels.ops")
SSM_MODULES = ("kernels.wkv_scan", "models.ssm", "configs.rwkv6_3b")
CLASSIFIER_MODULES = ("models.classifier", "data.synthetic", "training.loop")
ENCDEC_VLM_MODULES = ("models.encdec", "configs.whisper_small",
                      "configs.phi_3_vision_4_2b")
SLICE_MODULES = (TRAINING_MODULES + SIGNAL_MODULES + SSM_MODULES
                 + CLASSIFIER_MODULES + ENCDEC_VLM_MODULES)


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            # dynamic imports by dotted name ("repro.x" / "jax.numpy")
            head = node.value.split(".")[0]
            if "." in node.value and " " not in node.value and head in FORBIDDEN:
                yield head


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_repro(path):
    assert not set(_imported_roots(path)) & FORBIDDEN


def test_import_check_covers_the_training_slice():
    src = REPO / "src" / "repro_torch"
    for mod in TRAINING_MODULES:
        assert src / (mod.replace(".", "/") + ".py") in PORT_FILES, mod


def test_import_check_covers_the_signal_slice():
    src = REPO / "src" / "repro_torch"
    for mod in SIGNAL_MODULES:
        assert src / (mod.replace(".", "/") + ".py") in PORT_FILES, mod


def test_import_check_covers_the_ssm_slice():
    src = REPO / "src" / "repro_torch"
    for mod in SSM_MODULES:
        assert src / (mod.replace(".", "/") + ".py") in PORT_FILES, mod
    from repro_torch.kernels import _build
    assert (_build.CSRC / "wkv_scan.cu").exists()
    assert "wkv_scan" in _build.SOURCES


def test_import_check_covers_the_classifier_slice():
    src = REPO / "src" / "repro_torch"
    for mod in CLASSIFIER_MODULES:
        assert src / (mod.replace(".", "/") + ".py") in PORT_FILES, mod


def test_import_check_covers_the_encdec_and_vlm_slice():
    src = REPO / "src" / "repro_torch"
    for mod in ENCDEC_VLM_MODULES:
        assert src / (mod.replace(".", "/") + ".py") in PORT_FILES, mod


def test_build_names_every_cuda_source():
    from repro_torch.kernels import _build
    found = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert sorted(_build.SOURCES) == found
    assert {"deferral_entropy", "flash_attention"} <= set(found)


def test_port_modules_load_without_jax():
    code = ("import sys, importlib, pkgutil, repro_torch\n"
            "for m in pkgutil.walk_packages(repro_torch.__path__, "
            "'repro_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n"
            f"want = {SLICE_MODULES!r}\n"
            "missing = [m for m in want if 'repro_torch.' + m not in "
            "sys.modules]\n"
            "assert not missing, missing\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          env={"PYTHONPATH": str(REPO / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from repro_torch.configs import get_config, reduced
    from repro_torch.convert import params_from_jax
    from repro_torch.launch import serve, train
    from repro_torch.models import transformer as tfm
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("internlm2-1.8b"))
    for call in (lambda: tfm.init_params(cfg),
                 lambda: tfm.init_cache(cfg, 1, 4),
                 lambda: params_from_jax({}),
                 lambda: serve.build_ladder("internlm2-1.8b", 0, 2),
                 lambda: serve.main(["--requests", "2"]),
                 lambda: train.main(["--reduced", "--stage1-steps", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert tfm.init_params(cfg, device="cpu")["embedding"].device.type == "cpu"


@pytest.mark.parametrize("argv", [
    ["--tiers", "3"],
    ["--signal-k", "3", "--signal", "semantic_agreement"],
    ["--signal", "semantic_agreement"],
    ["--recalibrate"],
    ["--recalib-step", "0.1", "--recalibrate"],
    ["--profile-dir", "prof"],
    ["--metrics-port", "0"],
    ["--arch", "whisper-small"],
], ids=lambda a: a[0] if a[0] != "--backend" else a[-2])
def test_cli_rejects_unported_features_by_name(argv, capsys, tmp_path):
    """The flags this test once held refused by name are served now (the
    ladder, the semantic-agreement signal, recalibration, the profiler
    window and the /metrics endpoint); what stays refused by name is an
    arch the engine does not take (frames or patches)."""
    from repro_torch.launch import serve
    if argv[0] == "--arch":
        with pytest.raises(SystemExit) as exc:
            serve.main(["--device", "cpu"] + argv)
        assert exc.value.code == 2
        assert "ROADMAP.md" in capsys.readouterr().err
        return
    argv = [str(tmp_path / a) if a == "prof" else a for a in argv]
    res = serve.main(["--device", "cpu", "--requests", "4", "--max-new",
                      "3"] + argv)
    out = capsys.readouterr().out
    assert len(res.requests) == 4 and "ROADMAP.md" not in out
    st = res.stats
    if argv[0] == "--tiers":
        assert st["n_tiers"] == 3 and len(st["edge_tau"]) == 2
    elif argv[0].startswith("--signal"):
        assert st["edge_signal"] == ["semantic_agreement"]
    elif argv[0].startswith("--recalib"):
        assert st["edge_tau"] == st["recalibration"]["tau_final"]
    elif argv[0] == "--profile-dir":
        traces = list((tmp_path / "prof").glob("*.json"))
        assert len(traces) == 1 and str(traces[0]) in out
    else:
        assert "metrics endpoint: http://127.0.0.1:" in out


@pytest.mark.parametrize("arch", ["whisper-small", "phi-3-vision-4.2b"])
def test_cli_refuses_the_encdec_and_vlm_families(arch, capsys):
    """Both configs resolve, but the serve CLI takes token prompts only
    (as JAX's does): refused at argparse time, naming ROADMAP.md."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    assert get_config(arch).name == arch
    with pytest.raises(SystemExit) as exc:
        serve.main(["--device", "cpu", "--arch", arch])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"--arch {arch}" in err and "ROADMAP.md" in err


def test_cli_has_every_option_string_of_jax_serve():
    """The port's serve parser takes every option string of JAX's
    `repro.launch.serve` parser (read from its argparse calls), with the
    same defaults, plus --device."""
    import argparse
    from unittest import mock

    from repro.launch import serve as jserve
    from repro_torch.launch import serve
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)
    with mock.patch.object(argparse.ArgumentParser, "parse_args", capture):
        with pytest.raises(SystemExit):
            jserve.main([])
    jparser = seen["parser"]
    tparser = serve.build_parser()
    jopts = {o: a for a in jparser._actions for o in a.option_strings}
    topts = {o: a for a in tparser._actions for o in a.option_strings}
    assert set(jopts) - set(topts) == set()
    assert set(topts) - set(jopts) == {"--device"}
    for o, a in jopts.items():
        assert (topts[o].default, topts[o].choices) == (a.default,
                                                        a.choices), o


def test_cli_rejects_paged_knobs_on_slot_backend(capsys):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--block-size", "4"])
    assert "needs --backend paged" in capsys.readouterr().err


def test_chip_smoke_refuses_without_card_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
