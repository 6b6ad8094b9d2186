"""The port's dry-run (``repro_torch.launch.dryrun``) and
``inspect_cell``: ``run_cell`` on reduced configs of every family at small
shapes on a (2, 2) abstract mesh; ``main`` at full size on one cell
writes a row with the reference's keys (``count_s`` for ``compile_s``),
merges into an existing file, skips with the reference's reason and
exits 1 when a cell fails; ``--multi-pod`` on one cell; and
``inspect_cell.main`` prints its four sections."""
import json
import math

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import Shape  # noqa: E402
from repro_torch.launch import dryrun, inspect_cell  # noqa: E402
from repro_torch.sharding import AbstractMesh  # noqa: E402

FAMILY_ARCHS = ["qwen3-4b", "phi-3-vision-4.2b", "qwen3-moe-235b-a22b",
                "rwkv6-7b", "zamba2-2.7b", "whisper-base"]


def _reference_keys():
    rep = jroof.RooflineReport(
        arch="a", shape="s", mesh="m", chips=1, flops_per_device=1.0,
        bytes_per_device=1.0, coll={"wire_bytes": 0.0, "count": 0},
        argument_bytes=0, temp_bytes=0, output_bytes=0,
        model_flops_total=1.0)
    # repro.launch.dryrun.run_cell's row: rep.row() plus these
    return set(rep.row()) | {"count_s", "status", "temp_bytes_gib",
                             "arg_bytes_gib"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_run_cell_reduced(arch, kind):
    cfg = configs.reduced(configs.get_config(arch))
    mesh = AbstractMesh((2, 2), ("data", "model"))
    row = dryrun.run_cell(cfg, Shape(kind, 32, 4, kind), mesh, "2x2")
    assert set(row) == _reference_keys()
    assert row["status"] == "ok" and row["chips"] == 4
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert row["step_s"] == max(row["compute_s"], row["memory_s"],
                                row["collective_s"]) > 0
    for k in ("flops/dev", "bytes/dev", "coll_wire_bytes/dev", "mfu",
              "arg_bytes/dev", "temp_bytes/dev"):
        assert math.isfinite(row[k]) and row[k] > 0, k


def test_main_full_size_one_cell(tmp_path):
    out = tmp_path / "rows.json"
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k",
                        "--out", str(out)]) == 0
    rows = json.loads(out.read_text())
    assert len(rows) == 1
    row = rows[0]
    assert set(row) == _reference_keys()
    assert (row["arch"], row["shape"], row["mesh"], row["chips"]) == (
        "smollm-360m", "decode_32k", "16x16", 256)
    # a second cell merges in; the skip carries the reference's reason
    assert dryrun.main(["--arch", "smollm-360m", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    rows = {r["shape"]: r for r in json.loads(out.read_text())}
    assert set(rows) == {"decode_32k", "long_500k"}
    assert rows["long_500k"]["status"] == "skip"
    assert rows["long_500k"]["reason"] == jconfigs.skip_reason(
        jconfigs.get_config("smollm-360m"), jconfigs.SHAPES["long_500k"])


def test_main_multi_pod(tmp_path):
    out = tmp_path / "mp.json"
    assert dryrun.main(["--arch", "granite-moe-1b-a400m", "--shape",
                        "decode_32k", "--multi-pod", "--out", str(out)]) == 0
    (row,) = json.loads(out.read_text())
    assert (row["mesh"], row["chips"], row["status"]) == ("2x16x16", 512,
                                                          "ok")


def test_main_exits_1_on_a_failed_cell(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    out = tmp_path / "f.json"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k",
                        "--out", str(out)]) == 1
    (row,) = json.loads(out.read_text())
    assert row["status"] == "fail" and "planted" in row["error"]


def test_inspect_cell_prints_four_sections(capsys):
    assert inspect_cell.main(["--arch", "granite-moe-1b-a400m", "--shape",
                              "train_4k", "--layers", "1", "--top", "5"]) == 0
    text = capsys.readouterr().out
    for head in ("== largest per-device argument shards ==", "== counted ==",
                 "== largest tensors created ==", "== collectives =="):
        assert head in text
    assert "opt_state.m.embed" in text and "spec=P(" in text
    assert "peak live=" in text and "bfloat16[" in text
    assert "'all-to-all'" in text


def test_decode_cell_attends_to_the_whole_context():
    """A decode cell writes the cache's last slot (pos = S − 1): the step
    reads all S positions, so its FLOPs grow by 4·B·H·hd per layer and
    position of context."""
    from repro_torch.launch.roofline import count_cost
    from repro_torch.launch.steps import build_cell

    cfg = configs.reduced(configs.get_config("qwen3-4b"))
    mesh = AbstractMesh((1, 1), ("data", "model"))
    flops = {}
    for s in (64, 128):
        cell = build_cell(cfg, Shape("d", s, 2, "decode"), mesh,
                          layer_unroll=cfg.n_layers)
        flops[s] = count_cost(cell.fn, *cell.args).flops
        assert cell.args[2]["pos"] == s         # wrote slot s − 1
        cell.fn(*cell.args)                     # repeats the same step
        assert cell.args[2]["pos"] == s
    assert flops[128] - flops[64] == (4 * 2 * cfg.n_heads * cfg.hd * 64
                                      * cfg.n_layers)


def test_audio_depths_must_match():
    from repro_torch.launch.steps import build_cell

    cfg = configs.reduced(configs.get_config("whisper-base")).replace(
        n_encoder_layers=3)
    with pytest.raises(ValueError, match="encoder depth"):
        build_cell(cfg, Shape("t", 16, 2, "train"),
                   AbstractMesh((1, 1), ("data", "model")))


def test_big_models_keep_bf16_moments_at_any_depth():
    """The moment dtype follows the full config's parameter count (above
    10B: bf16), not the cell's trips of depth."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import build_cell

    for arch, want in (("qwen3-moe-235b-a22b", torch.bfloat16),
                       ("qwen3-4b", torch.float32)):
        cell = build_cell(configs.get_config(arch), configs.SHAPES["train_4k"],
                          make_production_mesh())
        assert {t.dtype for t in cell.args[1]["m"].values()} == {want}
