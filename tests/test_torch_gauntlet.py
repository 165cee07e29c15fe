"""The port's accuracy gauntlet (``mx_rcnn_tpu_torch/tools/gauntlet.py``)
held against the JAX tool on the CPU.

Summaries, paired comparisons and markdown equal the JAX functions' on
the committed records and the fabricated ones of
``tests/test_gauntlet.py``; the CLI's reuse, refusal and validation give
the JAX CLI's exit codes and lines; for every mode ``run_one`` makes the
JAX tool's calls (training and eval replaced by recorders in both
packages); and one real tiny run on the CPU writes a record with the JAX
record's keys.
"""

import argparse
import dataclasses
import json
import os

import pytest

from mx_rcnn_tpu.tools import gauntlet as jg
from mx_rcnn_tpu_torch.tools import gauntlet as tg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(REPO, "docs")


def _doc(name):
    with open(os.path.join(DOCS, name)) as f:
        return json.load(f)


def _recs(mode, maps, network="tiny"):
    return [{"mode": mode, "network": network, "seed": s, "mAP": m}
            for s, m in enumerate(maps)]


BASE = [0.7648, 0.7448, 0.7638, 0.7332, 0.7517]


def _record_sets():
    mixed = _recs("e2e", [0.70, 0.71])
    for r, ep in zip(mixed, (30, 20)):
        r.update(epochs=ep, lr=3e-3, lr_step=None, batch_images=2)
    quant = [dict(r, mode="quant", quant="int8/native/absmax/b8",
                  mAP=round(r["mAP"] - 0.004, 4))
             for r in _doc("gauntlet_results.json")[:3]]
    return {
        "results": _doc("gauntlet_results.json"),
        "redteam": _doc("gauntlet_redteam.json"),
        "ablations": _doc("gauntlet_results.json")
        + _doc("gauntlet_ablations.json"),
        "mixed_recipes": mixed,
        "neutral": _recs("e2e", BASE) + _recs("prenms", [
            m + d for m, d in zip(BASE, [0.002, -0.003, 0.001, 0.0,
                                         -0.002])]),
        "regression": _recs("e2e", BASE) + _recs("prenms", [
            m - 0.015 + j for m, j in zip(BASE, [0.001, -0.002, 0.002,
                                                 -0.001, 0.0])]),
        "single_seed": _recs("e2e", [0.75]) + _recs("prenms", [0.75]),
        "quant": _doc("gauntlet_results.json") + quant,
    }


RECORD_SETS = _record_sets()
COMPARES = [
    ("redteam", "e2e", "redteam", 0.02, None),
    ("ablations", "e2e", "alternate", 0.02, None),
    ("ablations", "e2e", "prenms", 0.02, None),
    ("ablations", "e2e", "prenms", 0.05, [0, 1]),
    ("neutral", "e2e", "prenms", 0.02, None),
    ("regression", "e2e", "prenms", 0.01, None),
    ("regression", "e2e", "prenms", 0.05, None),
    ("single_seed", "e2e", "prenms", 0.02, None),
    ("quant", "e2e", "quant", 0.02, [0, 1, 2]),
]


@pytest.mark.parametrize("name", sorted(RECORD_SETS))
def test_summarize_and_markdown_equal_jax(tmp_path, name):
    recs = RECORD_SETS[name]
    assert tg.summarize(recs) == jg.summarize(recs)
    jg.render_markdown(recs, str(tmp_path / "jax.md"))
    tg.render_markdown(recs, str(tmp_path / "port.md"))
    assert (tmp_path / "port.md").read_bytes() == \
        (tmp_path / "jax.md").read_bytes()
    assert [tg._recipe_str(r) for r in recs] == \
        [jg._recipe_str(r) for r in recs]


@pytest.mark.parametrize("name,a,b,budget,seeds", COMPARES,
                         ids=[f"{c[0]}-{c[2]}-{c[3]}" for c in COMPARES])
def test_paired_compare_equals_jax(name, a, b, budget, seeds):
    recs = RECORD_SETS[name]
    want = jg.paired_compare(recs, a, b, "tiny", budget=budget, seeds=seeds)
    assert tg.paired_compare(recs, a, b, "tiny", budget=budget,
                             seeds=seeds) == want


def test_paired_compare_verdicts():
    """The JAX tests' verdicts, through the port's function."""
    neutral = tg.paired_compare(RECORD_SETS["neutral"], "e2e", "prenms",
                                "tiny", budget=0.02)
    assert neutral["within_budget"] is True
    reg = tg.paired_compare(RECORD_SETS["regression"], "e2e", "prenms",
                            "tiny", budget=0.01)
    assert reg["within_budget"] is False and reg["sign_test_p"] == 0.0625
    red = tg.paired_compare(RECORD_SETS["redteam"], "e2e", "redteam", "tiny")
    assert red["within_budget"] is False
    assert all(d < -red["budget"] for d in red["deltas"])
    one = tg.paired_compare(RECORD_SETS["single_seed"], "e2e", "prenms",
                            "tiny")
    assert one["within_budget"] is False
    for mod in (jg, tg):
        with pytest.raises(ValueError, match="no common seeds"):
            mod.paired_compare(_recs("e2e", [0.75]), "e2e", "prenms", "tiny")


def test_constants_equal_jax():
    assert tg._MODES == jg._MODES
    assert tg._REDTEAM_NMS == jg._REDTEAM_NMS
    assert tg._QUANT_REDTEAM_BITS == jg._QUANT_REDTEAM_BITS


def _cli(mod, capsys, argv):
    """(exit code or SystemExit code, stdout JSON lines, stderr)."""
    try:
        rc = mod.main(argv)
    except SystemExit as e:
        rc = ("exit", e.code)
    out, err = capsys.readouterr()
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    return rc, lines, err


@pytest.mark.parametrize("arm", [0.001, -0.04])
def test_compare_cli_reuse_equals_jax(tmp_path, capsys, arm):
    base = BASE[:3]
    got = []
    for mod in (jg, tg):
        out = tmp_path / f"{mod.__name__}.json"
        out.write_text(json.dumps(_recs("e2e", base) + _recs(
            "prenms", [m + arm for m in base])))
        got.append(_cli(mod, capsys, [
            "--out", str(out), "--root", str(tmp_path),
            "--workdir", str(tmp_path / "w"), "--seeds", "0", "1", "2",
            "--compare", "e2e", "prenms"])[:2])
    assert got[1] == got[0]
    assert got[1][0] == (0 if arm > 0 else 1)
    cmp = [ln for ln in got[1][1] if "compare" in ln]
    assert cmp and cmp[0]["compare"] == "prenms-vs-e2e"


def test_cli_refuses_recipe_mismatch_as_jax(tmp_path, capsys):
    recs = _recs("e2e", [0.7, 0.71, 0.72])
    for r in recs:
        r["epochs"] = 30
    for mod in (jg, tg):
        out = tmp_path / f"{mod.__name__}.json"
        out.write_text(json.dumps(recs))
        rc, _, err = _cli(mod, capsys, [
            "--out", str(out), "--root", str(tmp_path),
            "--workdir", str(tmp_path / "w"), "--seeds", "0",
            "--mode", "e2e", "--epochs", "2"])
        assert rc == ("exit", 2)
        assert "DIFFERENT recipe" in err
        assert json.loads(out.read_text()) == recs


def test_cli_validates_every_cell_before_training_as_jax(tmp_path, capsys,
                                                          monkeypatch):
    recs = _recs("e2e", [0.7])
    recs[0]["epochs"] = 30
    for mod in (jg, tg):
        out = tmp_path / f"{mod.__name__}.json"
        out.write_text(json.dumps(recs))
        trained = []
        monkeypatch.setattr(mod, "run_one", lambda args, mode, seed:
                            trained.append((mode, seed)))
        rc, _, err = _cli(mod, capsys, [
            "--out", str(out), "--root", str(tmp_path),
            "--workdir", str(tmp_path / "w"), "--seeds", "1", "0",
            "--mode", "e2e", "--epochs", "2"])
        assert rc == ("exit", 2) and "DIFFERENT recipe" in err
        assert trained == []
        assert json.loads(out.read_text()) == recs


def test_cli_rejects_unknown_compare_mode_as_jax(tmp_path, capsys):
    for mod in (jg, tg):
        rc, _, err = _cli(mod, capsys, [
            "--out", str(tmp_path / "r.json"), "--compare", "e2e", "bogus"])
        assert rc == ("exit", 2) and "'bogus' not one of" in err


def test_cli_defaults_to_the_card(tmp_path, capsys, monkeypatch):
    """A cell to train on a machine without a card raises before any
    cell runs; the CPU runs only when asked for."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    trained = []
    monkeypatch.setattr(tg, "run_one", lambda args, mode, seed:
                        trained.append(args.device) or
                        {"mode": mode, "network": args.network,
                         "seed": seed, "mAP": 0.5})
    argv = ["--out", str(tmp_path / "r.json"), "--root", str(tmp_path),
            "--workdir", str(tmp_path / "w"), "--seeds", "0"]
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        tg.main(argv)
    assert trained == []
    assert tg.main(argv + ["--device", "cpu"]) == 0
    assert trained == ["cpu"]
    capsys.readouterr()


# ---------------------------------------------------------------------------
# run_one: the same calls in both packages, for every mode
# ---------------------------------------------------------------------------

def _cfg_diff(cfg, base):
    out = {}
    for f in dataclasses.fields(cfg):
        sec, bsec = getattr(cfg, f.name), getattr(base, f.name)
        for sf in dataclasses.fields(sec):
            if getattr(sec, sf.name) != getattr(bsec, sf.name):
                out[f"{f.name}.{sf.name}"] = getattr(sec, sf.name)
    return out


def _args(tmp_path, epochs=9):
    return argparse.Namespace(
        network="tiny", epochs=epochs, lr=3e-3, lr_step=None,
        batch_images=2, prenms_n=750, root=str(tmp_path / "root"),
        workdir=str(tmp_path / "work"), device="cpu")


def _install_recorders(mod, monkeypatch, base, calls):
    """Replace ``mod``'s package's train_net, alternate_train and
    test_rcnn by recorders of their calls into ``calls``."""
    import importlib

    pkg = mod.__name__.split(".")[0]
    train = importlib.import_module(f"{pkg}.tools.train")
    alt = importlib.import_module(f"{pkg}.tools.train_alternate")
    test = importlib.import_module(f"{pkg}.tools.test")

    def train_net(cfg, **kw):
        calls.append(("train_net", _cfg_diff(cfg, base), {
            k: kw.get(k) for k in ("prefix", "end_epoch", "lr", "lr_step",
                                   "seed", "frequent", "mode")}))

    def alternate_train(cfg, **kw):
        calls.append(("alternate_train", _cfg_diff(cfg, base), {
            k: kw.get(k) for k in ("prefix", "rpn_epoch", "rcnn_epoch",
                                   "rpn_lr", "rcnn_lr", "rpn_lr_step",
                                   "rcnn_lr_step", "frequent", "seed")}))
        return kw["prefix"] + "-final"

    def test_rcnn(cfg, **kw):
        calls.append(("test_rcnn", _cfg_diff(cfg, base), {
            k: kw.get(k) for k in ("prefix", "epoch", "verbose")}))
        return {"mAP": 0.612345, "circle": 0.5, "square": 0.72449}

    monkeypatch.setattr(train, "train_net", train_net)
    monkeypatch.setattr(alt, "alternate_train", alternate_train)
    monkeypatch.setattr(test, "test_rcnn", test_rcnn)
    return train


def _recorded(mod, monkeypatch, tmp_path, mode, seed):
    """``mod.run_one`` with training and eval replaced by recorders:
    (calls, record, base config)."""
    args = _args(tmp_path)
    base = mod._base_cfg(args)
    calls = []
    _install_recorders(mod, monkeypatch, base, calls)
    rec = mod.run_one(args, mode, seed)
    return calls, rec, base


@pytest.mark.parametrize("mode", jg._MODES)
def test_run_one_makes_the_jax_calls(tmp_path, monkeypatch, mode):
    jcalls, jrec, jbase = _recorded(jg, monkeypatch, tmp_path, mode, 3)
    tcalls, trec, tbase = _recorded(tg, monkeypatch, tmp_path, mode, 3)
    assert tcalls == jcalls
    assert trec == jrec
    assert len(tcalls) == 2 and tcalls[-1][0] == "test_rcnn"
    # the base configs agree on every key both declare
    jsec = {f.name for f in dataclasses.fields(jbase)}
    for f in dataclasses.fields(tbase):
        assert f.name in jsec
        for sf in dataclasses.fields(getattr(tbase, f.name)):
            jv = getattr(getattr(jbase, f.name), sf.name)
            tv = getattr(getattr(tbase, f.name), sf.name)
            assert tv == jv, (f.name, sf.name)


def test_run_one_pins_and_restores_the_algorithms(tmp_path, monkeypatch):
    """Training runs under quant_smoke.reproducible's pins; the caller's
    settings come back afterwards."""
    import torch

    args = _args(tmp_path, epochs=2)
    train = _install_recorders(tg, monkeypatch, tg._base_cfg(args), [])
    seen = []
    monkeypatch.setattr(train, "train_net", lambda cfg, **kw: seen.append(
        (torch.are_deterministic_algorithms_enabled(),
         torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32)))
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    was = torch.are_deterministic_algorithms_enabled()
    tg.run_one(args, "e2e", 0)
    assert seen == [(True, False, False, False)]
    assert torch.are_deterministic_algorithms_enabled() == was
    assert torch.backends.cudnn.benchmark is True
    assert torch.backends.cudnn.allow_tf32 is True
    assert torch.backends.cuda.matmul.allow_tf32 is True


# ---------------------------------------------------------------------------
# one real run on the CPU
# ---------------------------------------------------------------------------

def test_one_real_tiny_run_writes_the_jax_record(tmp_path, monkeypatch,
                                                 capsys):
    """The tiny network for one epoch on the CPU, through ``main``; the
    generated set is cut to 8 train / 4 test images to keep the test
    short (the tool itself reads 400 / 100)."""
    from mx_rcnn_tpu_torch.data import synthetic

    init = synthetic.HardSyntheticDataset.__init__

    def small(self, image_set="train", num_images=None, *a, **kw):
        if num_images is None:
            num_images = 8 if "train" in image_set else 4
        init(self, image_set, num_images, *a, **kw)

    monkeypatch.setattr(synthetic.HardSyntheticDataset, "__init__", small)
    out = tmp_path / "results.json"
    rc = tg.main(["--root", str(tmp_path), "--workdir",
                  str(tmp_path / "work"), "--out", str(out),
                  "--seeds", "0", "--epochs", "1", "--device", "cpu"])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert len(recs) == 1
    rec = recs[0]
    _, jrec, _ = _recorded(jg, monkeypatch, tmp_path, "e2e", 0)
    assert sorted(rec) == sorted(jrec)
    assert len(rec["per_class"]) == 8   # the 8 foreground classes
    assert (rec["mode"], rec["network"], rec["seed"], rec["epochs"],
            rec["lr"], rec["lr_step"], rec["batch_images"]) == \
        ("e2e", "tiny", 0, 1, 3e-3, None, 2)
    assert 0.0 <= rec["mAP"] <= 1.0
    assert (tmp_path / "work" / "e2e-tiny-s0-0001.ckpt").exists()
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert lines[-1]["group"] == "e2e/tiny"
