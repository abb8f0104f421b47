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
    # serving over ranks (ROADMAP Queue 1 item 6b): the fixed-batch steps,
    # the paged engine's steps and pools, and the resilient loop
    from repro_torch.kernels.flash_attention import paged_route
    from repro_torch.runtime import paged as PG
    from repro_torch.runtime.resilient import ResilientServeLoop, ServeLoopConfig

    llama = build_model(get_config("llama3.2-1b"), tp=1)
    for topo in (MiCSTopology(repl=2, shard=2), MiCSTopology(model=2)):
        with pytest.raises(NotImplementedError, match="Queue 1 item 6b"):
            build_serve_steps(llama, topo, MiCSConfig(), 24, device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1 item 6b"):
            PG.build_paged_step(llama, topo, MiCSConfig(), max_blocks=2, device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1 item 6b"):
            PG.init_paged_caches(llama, topo, 4, 16, device="cpu")
        with pytest.raises(NotImplementedError, match="Queue 1 item 6b"):
            ResilientServeLoop(llama, topo, MiCSConfig(),
                               ServeLoopConfig(slots_local=1, nb_local=3, block_size=16,
                                               max_blocks=2), device="cpu")
    # fp32 KV pools (and fp32 queries) take no CUDA route of the paged kernel
    with pytest.raises(NotImplementedError, match="fp32 KV pools on the card"):
        paged_route(torch.bfloat16, torch.float32)
    with pytest.raises(NotImplementedError, match="fp32 KV pools on the card"):
        paged_route(torch.float32, torch.float32)
    # the paged engine serves the dense family only (griffin's caches are
    # windowed and recurrent), and the kv settings are validated
    with pytest.raises(NotImplementedError, match="window"):
        PG.init_paged_caches(build_model(get_config("recurrentgemma-2b"), tp=1),
                             MiCSTopology(), 4, 16, device="cpu")
    for kw in (dict(kv_dtype="fp8"), dict(kv_block_size=0), dict(max_resident_requests=-1)):
        with pytest.raises(ValueError):
            MiCSConfig(**kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        PG.build_paged_step(llama, MiCSTopology(), MiCSConfig(policy="auto"), max_blocks=2,
                            device="cpu")
    # The staged settings build engines whose policy is the config's.
    for staged, (topology, inner) in ((dict(hierarchical=False), ("flat", None)),
                                      (dict(gather_order="outer_first"), ("outer_first", None)),
                                      (dict(hierarchy_inner=2), ("inner_first", 2))):
        gp = CommEngine.from_config(MiCSTopology(), MiCSConfig(**staged)).gather_policy
        assert (gp.topology, gp.inner) == (topology, inner)
    assert CommEngine.from_config(MiCSTopology(), MiCSConfig()).gather_policy == GatherPolicy()
    xlstm = ArchConfig(name="x", family="xlstm", n_layers=2, d_model=64, n_heads=4,
                       n_kv_heads=4, d_ff=128, vocab=256)
    with pytest.raises(NotImplementedError):
        build_model(xlstm, tp=1)
    gelu = ArchConfig(name="w", family="dense", n_layers=2, d_model=64, n_heads=4,
                      n_kv_heads=4, d_ff=128, vocab=256, mlp="gelu")
    with pytest.raises(NotImplementedError):
        build_model(gelu, tp=1)
    from repro_torch.models import blocks
    from repro_torch.models.layers import Ctx

    with pytest.raises(NotImplementedError, match="gelu"):  # never a quiet SwiGLU
        blocks.mlp_apply(gelu, {}, torch.zeros(1, 1, 64), Ctx())
    with pytest.raises(KeyError):
        get_config("xlstm-125m")
