"""The port stands alone: no module of ``repro_torch`` nor ``chip_smoke.py``
imports ``jax`` or the JAX package, and its entry points refuse to run on
the CPU unless asked to."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", _files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = {n for n in _imported(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_import_all_modules_leaves_no_jax():
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__") for p in PORT.rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"mods = {mods!r}\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120, env={"PYTHONPATH": str(ROOT / "src"),
                                                       "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["n"] >= 19 and res["bad"] == []
    for m in ("repro_torch.models.recurrent", "repro_torch.kernels.rglru",
              "repro_torch.kernels.rglru.kernel", "repro_torch.configs.recurrentgemma_2b",
              "repro_torch.core.collectives", "repro_torch.launch.mesh",
              "repro_torch.core.quant", "repro_torch.kernels.quant",
              "repro_torch.kernels.quant.kernel"):
        assert m in mods


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-2b"])
def test_entry_points_refuse_cpu_fallback(arch):
    from repro_torch.configs import get_config, smoke_variant
    from repro_torch.core.mics import MiCSConfig, init_params
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models.build import build_model
    from repro_torch.runtime.serving import build_serve_steps

    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is for hosts without one")
    model = build_model(smoke_variant(get_config(arch)), tp=1)
    with pytest.raises(RuntimeError, match="cuda"):
        init_params(model, seed=0)
    with pytest.raises(RuntimeError, match="cuda"):
        build_serve_steps(model, MiCSTopology(), MiCSConfig(), 24)


def test_later_slices_raise():
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.comm import CommEngine, GatherPolicy
    from repro_torch.core.mics import MiCSConfig
    from repro_torch.core.topology import MiCSTopology
    from repro_torch.models.build import build_model
    from repro_torch.runtime.serving import build_serve_steps

    # p > 1 and tp > 1 run over the process groups of their topology, and
    # refuse to build without them
    with pytest.raises(ValueError, match="MiCSGroups"):
        CommEngine(MiCSTopology(shard=4))
    with pytest.raises(ValueError, match="MiCSGroups"):
        CommEngine(MiCSTopology(model=2))
    # the int8 and bf16 wires (Queue 1 item 4) build; unknown wires do not
    assert CommEngine(MiCSTopology(), GatherPolicy(wire_dtype="int8")).gather_out_dtype() \
        == torch.bfloat16
    for kw in (dict(hop1_wire_dtype="bf16"), dict(hop1_wire_dtype="int8"),
               dict(compress_hop2="int8"), dict(quant_gather=True)):
        CommEngine.from_config(MiCSTopology(), MiCSConfig(**kw))
    for kw in (dict(hop1_wire_dtype="fp16"), dict(compress_hop2="int4"),
               dict(grad_rounding="down")):
        with pytest.raises(ValueError):
            MiCSConfig(**kw)
    # serving over ranks: the fixed-batch steps, the paged engine's steps
    # and the resilient loop run over the process groups of their topology
    # and refuse to build without them; a rank's pools hold its heads
    from repro_torch.kernels.flash_attention import paged_route
    from repro_torch.runtime import paged as PG
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig
    from repro_torch.runtime.serving import resize_for_serve_world

    llama = build_model(get_config("llama3.2-1b"), tp=1)
    for topo in (MiCSTopology(repl=2, shard=2), MiCSTopology(model=2)):
        model = llama if topo.model_size == 1 else build_model(get_config("llama3.2-1b"), tp=2)
        with pytest.raises(ValueError, match="MiCSGroups"):
            build_serve_steps(model, topo, MiCSConfig(), 24, device="cpu")
        with pytest.raises(ValueError, match="MiCSGroups"):
            PG.build_paged_step(model, topo, MiCSConfig(), max_blocks=2, device="cpu")
        with pytest.raises(ValueError, match="MiCSGroups"):
            ResilientServeLoop(model, topo, MiCSConfig(),
                               ServeLoopConfig(slots_local=1, nb_local=3, block_size=16,
                                               max_blocks=2), device="cpu")
        pools = PG.init_paged_caches(model, topo, 4, 16, device="cpu")
        assert pools["layers"]["k"].shape == (16, 4, 16, 8 // topo.model_size, 64)
    with pytest.raises(ValueError, match="built for tp = 1"):
        build_serve_steps(llama, MiCSTopology(model=2), MiCSConfig(), 24, device="cpu")
    # the world re-rank of the serve policy (autotune.rerank_serve_world,
    # numerics pinned) and a re-pick under a memory budget run
    llama2 = build_model(get_config("llama3.2-1b"), tp=2)
    topo, mcfg2, info = resize_for_serve_world(llama2, MiCSConfig(), 2, tp=2, partition_size=2,
                                               available=4)
    assert (topo.partition_size, topo.model_size, info["world"]) == (1, 2, 2)
    assert info["serve_rerank"]["kv_dtype"] == mcfg2.kv_dtype == "bf16"
    assert mcfg2.policy == "manual" and mcfg2.gather_dtype == torch.bfloat16
    topo, _, info = resize_for_serve_world(llama, MiCSConfig(hbm_budget_gb=40.0), 2,
                                           available=4)
    assert info["rule"] == "resolve_scale" and topo.partition_size == info["partition_size"]
    prefill_fn, _ = build_serve_steps(llama, MiCSTopology(), MiCSConfig(policy="auto"), 24,
                                      device="cpu")
    assert prefill_fn.mcfg.policy == "manual"
    # fp32 KV pools take the paged route (its fma body) under bf16 and fp32
    # queries: the refusal of them is gone
    assert paged_route(torch.bfloat16, torch.float32) == "paged"
    assert paged_route(torch.float32, torch.float32) == "paged"
    # the paged engine serves the dense family only (griffin's caches are
    # windowed and recurrent), and the kv settings are validated
    with pytest.raises(NotImplementedError, match="window"):
        PG.init_paged_caches(build_model(get_config("recurrentgemma-2b"), tp=1),
                             MiCSTopology(), 4, 16, device="cpu")
    for kw in (dict(kv_dtype="fp8"), dict(kv_block_size=0), dict(max_resident_requests=-1)):
        with pytest.raises(ValueError):
            MiCSConfig(**kw)
    step = PG.build_paged_step(llama, MiCSTopology(), MiCSConfig(policy="auto"), max_blocks=2,
                               device="cpu")
    assert step.mcfg.kv_dtype in ("fp32", "bf16") and step.mcfg.max_resident_requests > 0
    # The staged settings build engines whose policy is the config's.
    for staged, (topology, inner) in ((dict(hierarchical=False), ("flat", None)),
                                      (dict(gather_order="outer_first"), ("outer_first", None)),
                                      (dict(hierarchy_inner=2), ("inner_first", 2))):
        gp = CommEngine.from_config(MiCSTopology(), MiCSConfig(**staged)).gather_policy
        assert (gp.topology, gp.inner) == (topology, inner)
    assert CommEngine.from_config(MiCSTopology(), MiCSConfig()).gather_policy == GatherPolicy()
    # the encoder-decoder family and the LayerNorm + GeLU layers are built:
    # enc and dec pools, the biased GeLU MLP (never a quiet SwiGLU), and
    # get_config knows whisper and the paper's configs
    encdec = ArchConfig(name="e", family="encdec", n_layers=2, d_model=64, n_heads=4,
                        n_kv_heads=4, d_ff=128, vocab=256, n_encoder_layers=2, mlp="gelu",
                        norm="ln")
    assert [(p.name, p.stack) for p in build_model(encdec, tp=1).pools] == [("enc", 2),
                                                                            ("dec", 2)]
    gelu = ArchConfig(name="w", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=128, vocab=256, mlp="gelu")
    segs = [s.name for s in build_model(gelu, tp=1).pool("layers").layout.segments]
    assert {"mlp.w1", "mlp.b1", "mlp.b2"} <= set(segs) and "mlp.wg" not in segs
    from repro_torch.models import blocks
    from repro_torch.models.layers import Ctx

    with pytest.raises(KeyError, match="w1"):  # never a quiet SwiGLU
        blocks.mlp_apply(gelu, {}, torch.zeros(1, 1, 64), Ctx())
    assert get_config("whisper-large-v3").family == "encdec"
    assert get_config("bert-50b").mlp == "gelu"
