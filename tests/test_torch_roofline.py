"""The port's roofline harness (``repro_torch.launch.roofline``) against
the JAX package's (``repro.launch.roofline``) and against hand counts:

  * ``model_flops`` equals the reference's for all archs × shapes;
  * ``RooflineReport``'s terms, bottleneck, step, useful fraction and MFU
    equal the reference's on the same inputs, scaled by the ratio of the
    two sets of constants, and ``extrapolate_report`` extrapolates FLOPs,
    bytes and collectives as the reference does;
  * ``collective_bytes(records)`` equals the reference's
    ``collective_bytes(hlo_text)`` on HLO lines made from the same records
    (every kind, both ``replica_groups`` formats), exactly;
  * each collective rule on a hand-worked tiny cell;
  * the meta count equals the count of the same reduced cell run on real
    CPU tensors, exactly, for every family and kind;
  * the two-point extrapolation from 1 and 2 trips equals the count at
    full reduced depth (4 layers; hybrid 2 super-blocks), exactly;
  * a reduced dense prefill's FLOPs equal the closed form.
"""
from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch_parity  # noqa: E402,F401  (one torch thread per worker)
from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroof  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import Shape  # noqa: E402
from repro_torch.launch import roofline as roof  # noqa: E402
from repro_torch.launch.steps import build_cell, scan_trips  # noqa: E402
from repro_torch.sharding import AbstractMesh  # noqa: E402

MESH = AbstractMesh((2, 2), ("data", "model"))
FAMILY_ARCHS = ["smollm-360m", "qwen1.5-4b", "phi-3-vision-4.2b",
                "granite-moe-1b-a400m", "rwkv6-7b", "zamba2-2.7b",
                "whisper-base"]
KINDS = ["train", "prefill", "decode"]


@pytest.mark.parametrize("arch", sorted(jconfigs.ARCHS))
def test_model_flops_equal_reference(arch):
    for name, shape in configs.SHAPES.items():
        got = roof.model_flops(configs.get_config(arch), shape)
        want = jroof.model_flops(jconfigs.get_config(arch),
                                 jconfigs.SHAPES[name])
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def _reports(**fields):
    return roof.RooflineReport(**fields), jroof.RooflineReport(**fields)


COLL = {"all-gather": 3.0e9, "all-reduce": 1.0e9, "reduce-scatter": 2.0e8,
        "all-to-all": 0.0, "collective-permute": 0.0,
        "operand_bytes": 5.0e9, "count": 12, "wire_bytes": 4.2e9}


@pytest.mark.parametrize("flops,nbytes,wire", [
    (1.0e15, 1.0e11, 1.0e9), (1.0e12, 4.0e12, 1.0e8), (1.0e12, 1.0e9, 4.2e9)])
def test_report_properties_scale_with_constants(flops, nbytes, wire):
    got, want = _reports(
        arch="a", shape="s", mesh="16x16", chips=256,
        flops_per_device=flops, bytes_per_device=nbytes,
        coll=dict(COLL, wire_bytes=wire), argument_bytes=7, temp_bytes=5,
        output_bytes=3, model_flops_total=1.0e17)
    ratios = {"compute_s": jroof.PEAK_FLOPS / roof.PEAK_FLOPS,
              "memory_s": jroof.HBM_BW / roof.HBM_BW,
              "collective_s": jroof.LINK_BW / roof.LINK_BW}
    for name, ratio in ratios.items():
        np.testing.assert_allclose(getattr(got, name),
                                   getattr(want, name) * ratio, rtol=1e-12)
    terms = {"compute": got.compute_s, "memory": got.memory_s,
             "collective": got.collective_s}
    assert got.bottleneck == max(terms, key=terms.get)
    assert got.step_s == max(terms.values())
    assert got.useful_flops_frac == want.useful_flops_frac
    # mfu · chips · peak · step = model FLOPs, under either set of constants
    np.testing.assert_allclose(got.mfu * 256 * roof.PEAK_FLOPS * got.step_s,
                               want.mfu * 256 * jroof.PEAK_FLOPS
                               * want.step_s, rtol=1e-12)
    row = got.row()
    assert set(row) == set(want.row())
    assert row["coll_wire_bytes/dev"] == wire and row["coll_ops"] == 12
    assert roof.PEAK_FLOPS == 989e12 and roof.HBM_BW == 3.35e12 \
        and roof.LINK_BW == 50e9


@pytest.mark.parametrize("trips", [1, 2, 9, 94])
def test_extrapolate_equals_reference(trips):
    base = dict(arch="a", shape="s", mesh="m", chips=4, model_flops_total=1e9)
    r1 = dict(base, flops_per_device=1e9, bytes_per_device=3e8,
              coll=dict(COLL), argument_bytes=100, temp_bytes=50,
              output_bytes=10)
    c2 = {k: (v * 1.5 if isinstance(v, float) else v + 1)
          for k, v in COLL.items()}
    c2["all-to-all"] = 0.0
    r2 = dict(base, flops_per_device=1.7e9, bytes_per_device=2e8, coll=c2,
              argument_bytes=160, temp_bytes=70, output_bytes=10)
    got = roof.extrapolate_report(roof.RooflineReport(**r1),
                                  roof.RooflineReport(**r2), trips)
    want = jroof.extrapolate_report(jroof.RooflineReport(**r1),
                                    jroof.RooflineReport(**r2), trips)
    assert got.flops_per_device == want.flops_per_device
    assert got.bytes_per_device == want.bytes_per_device  # max(Δ, 0): c1
    assert got.coll == want.coll
    # the port's u = 1 cell holds one trip of parameters: memory
    # extrapolates too (the peak only where it grows: a train step)
    assert got.argument_bytes == 100 + (trips - 1) * 60
    assert got.temp_bytes == 50 + (trips - 1) * 20
    serve = roof.extrapolate_report(roof.RooflineReport(**r1),
                                    roof.RooflineReport(**r2), trips,
                                    temp_grows=False)
    assert serve.temp_bytes == (70 if trips > 1 else 70)


def _hlo_line(kind, n, in_b, out_b, fmt, i):
    groups = (f"replica_groups=[{8 // n if n <= 8 else 1},{n}]<=[{max(n, 8)}]"
              if fmt == "iota" else
              "replica_groups={" + ",".join(
                  "{" + ",".join(str(g * n + j) for j in range(n)) + "}"
                  for g in range(2)) + "}")
    if kind == "collective-permute":
        groups = "source_target_pairs={{0,1},{1,0}}"
    return (f"  %c{i} = u8[{out_b}]{{0}} {kind}(u8[{in_b}]{{0}} %p{i}), "
            f"{groups}, channel_id={i}")


@pytest.mark.parametrize("fmt", ["iota", "list"])
def test_collective_bytes_equals_reference(fmt):
    rng = np.random.default_rng(3)
    recs = []
    for i in range(60):
        kind = roof._KINDS[i % 5]
        n = int(rng.choice([1, 2, 4, 8, 16, 256]))
        in_b = int(rng.integers(1, 1 << 30))
        out_b = {"all-gather": in_b * n, "reduce-scatter": max(in_b // n, 1)
                 }.get(kind, in_b)
        recs.append((kind, n, in_b, out_b))
    text = "\n".join(["HloModule m", "ENTRY e {"] + [
        _hlo_line(k, n, ib, ob, fmt, i) for i, (k, n, ib, ob)
        in enumerate(recs)] + ["}"])
    got = roof.collective_bytes(recs)
    want = jroof.collective_bytes(text)
    assert got == want
    assert got["count"] == 60 and set(got) == set(want)


def _tiny(arch, **over):
    base = dict(n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, head_dim=8,
                d_ff=32, vocab=64)
    return configs.reduced(configs.get_config(arch)).replace(
        **{**base, **over})


def _records(cfg, shape, mesh=MESH):
    cell = build_cell(cfg, shape, mesh, layer_unroll=scan_trips(cfg))
    count = roof.count_cost(cell.fn, *cell.args,
                            watch=dict(cell.args[0].named_parameters()))
    return Counter(roof.collective_records(cell, count.uses))


def test_collective_rules_dense_train_by_hand():
    """smollm (tied embeddings), 1 layer, d 16, f 32, 2 heads / 1 kv of 8,
    vocab 64, f32, on (2, 2), B 2 × S 4, no remat: every weight is read
    twice (forward, backward), the tied embedding three times (lookup,
    head forward and backward)."""
    recs = _records(_tiny("smollm-360m"), Shape("t", 4, 2, "train"))
    ag = {  # name: (uses, shard bytes, gathered bytes) over data (2)
        "embed": (3, 1024, 2048), "wq": (2, 256, 512), "wk": (2, 128, 256),
        "wv": (2, 128, 256), "wo": (2, 256, 512), "w_gate": (2, 512, 1024),
        "w_up": (2, 512, 1024), "w_down": (2, 512, 1024)}
    want = Counter()
    for uses, shard, full in ag.values():
        want[("all-gather", 2, shard, full)] += uses
        want[("reduce-scatter", 2, full, shard)] += 1
    # wo and w_down are row-parallel: an (8 tokens, 16) f32 output over the
    # batch's 2 shards, once per use
    want[("all-reduce", 2, 256, 256)] += 4
    # the three norms are replicated: their gradients all-reduce over data
    want[("all-reduce", 2, 64, 64)] += 3
    assert recs == want


def test_collective_rules_moe_decode_by_hand():
    """granite-moe at 8 experts of 32, top 2, cf 8, 1 layer, d 16, on (2, 2),
    decode B 2: capacity ⌈8·2·2/8⌉ = 4 slots, 8·4 = 32 routed rows of 16
    f32 over 2 batch shards = 1,024 bytes: two all-to-alls over model, and
    the expert w_down's row-parallel all-reduce of the same size."""
    recs = _records(_tiny("granite-moe-1b-a400m"),
                    Shape("d", 8, 2, "decode"))
    assert recs[("all-to-all", 2, 1024, 1024)] == 2
    assert recs[("all-reduce", 2, 1024, 1024)] == 1
    # wo (2 tokens × 16 f32 / 2) and the sequence-sharded cache's one
    # layer (1 kv head over model: 1 × 2 heads × 8 f32)
    assert recs[("all-reduce", 2, 64, 64)] == 2
    assert sum(n for (k, *_), n in recs.items() if k == "all-to-all") == 2


def test_collective_rules_sequence_sharded_cache_by_hand():
    """1 kv head does not divide over model (2): the k/v caches shard their
    sequence instead, and a decode step all-reduces each layer's partial
    attention output (B/2 × 2 heads × 8 f32 = 64 bytes) over those axes:
    model when the batch shards, data × model at batch 1."""
    cfg = _tiny("smollm-360m", n_layers=2)
    recs = _records(cfg, Shape("d", 8, 2, "decode"))
    # 2 layers, and 2 × (wo, w_down): (2 tokens, 16) f32 over 2 shards
    assert recs[("all-reduce", 2, 64, 64)] == 2 + 4
    recs1 = _records(cfg, Shape("d", 8, 1, "decode"))
    assert recs1[("all-reduce", 4, 64, 64)] == 2
    # prefill writes its shards where they lie: no such all-reduce
    pre = _records(cfg, Shape("p", 8, 1, "prefill"))
    assert not any(k == "all-reduce" and n == 4 for (k, n, *_) in pre)


def _count(cfg, shape, trips, device="meta"):
    return roof.analyze_cell(build_cell(cfg, shape, MESH, trips,
                                        device=device), "2x2")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_meta_count_equals_cpu_count(arch, kind):
    cfg = configs.reduced(configs.get_config(arch))
    shape = Shape(kind, 32, 4, kind)
    rm, cm = _count(cfg, shape, 1)
    rc, cc = _count(cfg, shape, 1, device="cpu")
    for f in ("flops", "bytes", "peak_bytes", "output_bytes", "ops"):
        assert getattr(cm, f) == getattr(cc, f), f
    assert cm.buffers == cc.buffers and cm.uses == cc.uses
    assert rm.row() == rc.row()
    assert cm.flops > 0 and cm.peak_bytes > 0


def _full(cfg):
    if cfg.family == "hybrid":          # 3 super-blocks of 2
        return cfg.replace(n_layers=3 * cfg.shared_attn_every)
    if cfg.family == "audio":
        return cfg.replace(n_layers=4, n_encoder_layers=4)
    return cfg.replace(n_layers=4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_two_point_extrapolation_equals_full_depth(arch, kind):
    cfg = _full(configs.reduced(configs.get_config(arch)))
    shape = Shape(kind, 32, 4, kind)
    trips = scan_trips(cfg)
    assert trips == (3 if cfg.family == "hybrid" else 4)
    (r1, _), (r2, _), (rt, _) = (_count(cfg, shape, u)
                                 for u in (1, 2, trips))
    ex = roof.extrapolate_report(r1, r2, trips, temp_grows=kind == "train")
    assert ex.flops_per_device == rt.flops_per_device
    assert ex.bytes_per_device == rt.bytes_per_device
    assert ex.argument_bytes == rt.argument_bytes
    assert {k: v for k, v in ex.coll.items() if k != "count"} \
        == {k: v for k, v in rt.coll.items() if k != "count"}
    if kind == "train":   # the peak grows by a trip's saved state (a
        # few bytes of per-layer scalars off linear: the MoE aux losses)
        assert ex.temp_bytes == pytest.approx(rt.temp_bytes, rel=1e-4)
    else:                 # a serve step's peak: a layer's transients
        assert ex.temp_bytes == rt.temp_bytes


def test_dense_prefill_flops_closed_form():
    """qwen3 reduced (2 layers, d 64, 4 heads / 2 kv of 16, f 128), B 2 ×
    S 2,048: the plain route runs 2 query chunks of 1,024 against the full
    2,048 keys, so attention counts the full rectangle."""
    cfg = configs.reduced(configs.get_config("qwen3-4b"))
    b, s = 2, 2048
    cell = build_cell(cfg, Shape("p", s, b, "prefill"),
                      AbstractMesh((1, 1), ("data", "model")),
                      layer_unroll=cfg.n_layers)
    count = roof.count_cost(cell.fn, *cell.args)
    d, hd, h, kv, f = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, \
        cfg.d_ff
    matmul_params = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    want = (2 * matmul_params * b * s * cfg.n_layers
            + 4 * b * s * s * h * hd * cfg.n_layers
            + 2 * b * d * cfg.vocab)           # the head, last position
    assert count.flops == want
