"""Package-level properties of the port: its config and error-budget
copies equal the reference's, it loads neither JAX nor the reference
package, and its entry points refuse to fall back to the CPU quietly."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import configs as jconfigs
from repro.core.quant import ERROR_BUDGETS as J_BUDGETS
from repro_torch import configs as tconfigs
from repro_torch.core import execplan
from repro_torch.core.quant import ERROR_BUDGETS as T_BUDGETS

ROOT = Path(__file__).resolve().parents[1]
# the kernel wrappers of the port, one per CUDA kernel
_WRAPPERS = ("salr_matmul", "bitmap_matmul", "paged_gqa_attention", "qsalr_matmul",
             "ring_quant_gqa_attention", "paged_quant_gqa_attention",
             "ring_nf4_gqa_attention", "paged_nf4_gqa_attention", "nm_matmul",
             "lora_matmul", "nf4_matmul", "grouped_salr_matmul", "grouped_qsalr_matmul",
             "decode_salr_matmul", "decode_qsalr_matmul", "grouped_dense_matmul",
             "grouped_nm_matmul", "decode_dense_matmul", "decode_nm_matmul",
             "paged_mla_attention")


def _fields(obj):
    """Field-for-field view of a config value, recursing into dataclasses
    and tuples (compared by fields, not by class identity)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _fields(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (tuple, list)):
        return tuple(_fields(v) for v in obj)
    return obj


@pytest.mark.parametrize("smoke", [False, True])
def test_config_copies_equal_reference(smoke):
    assert tconfigs.PORTED == ["smollm_135m", "granite_moe_1b_a400m", "deepseek_v3_671b",
                               "llama3_8b_proxy", "internlm2_1_8b", "mistral_large_123b",
                               "nemotron_4_340b"]
    for name in tconfigs.PORTED:
        t, j = tconfigs.get(name, smoke=smoke), jconfigs.get(name, smoke=smoke)
        assert _fields(t) == _fields(j)
        assert (t.n_layers, t.resolved_head_dim) == (j.n_layers, j.resolved_head_dim)
    assert [f.name for f in dataclasses.fields(tconfigs.ArchConfig)] == \
        [f.name for f in dataclasses.fields(jconfigs.ArchConfig)]
    assert {k: _fields(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: _fields(v) for k, v in jconfigs.SHAPES.items()}


def test_mla_config_copy_equals_reference():
    """MLAConfig field for field (names, order, defaults), and deepseek's
    published and smoke MLA widths."""
    from repro.configs.base import MLAConfig as JMLA
    assert [(f.name, f.default) for f in dataclasses.fields(tconfigs.MLAConfig)] == \
        [(f.name, f.default) for f in dataclasses.fields(JMLA)]
    for smoke in (False, True):
        t, j = tconfigs.get("deepseek_v3_671b", smoke=smoke), jconfigs.get(
            "deepseek_v3_671b", smoke=smoke)
        assert isinstance(t.mla, tconfigs.MLAConfig)
        assert _fields(t.mla) == _fields(j.mla)
        assert (t.first_dense_layers, t.n_shared_experts) == (j.first_dense_layers,
                                                              j.n_shared_experts)
    assert _fields(tconfigs.get("deepseek_v3_671b").mla) == {
        "q_lora_rank": 1536, "kv_lora_rank": 512, "qk_nope_head_dim": 128,
        "qk_rope_head_dim": 64, "v_head_dim": 128}


def test_error_budgets_equal_reference():
    assert T_BUDGETS == J_BUDGETS


def test_port_imports_neither_jax_nor_reference():
    """Every repro_torch module and chip_smoke import without pulling in
    jax or repro (checked in a fresh interpreter)."""
    mods = sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert {"repro_torch.models.moe", "repro_torch.configs.granite_moe_1b_a400m"} <= set(mods)
    code = "\n".join([
        "import importlib, sys",
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]",
        f"for m in {mods!r}: importlib.import_module(m.removesuffix('.__init__'))",
        "import chip_smoke",
        "from repro_torch.kernels import ops",
        f"assert all(callable(getattr(ops, n)) for n in {_WRAPPERS!r})",
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))",
        "print(len(sys.modules)); assert not bad, bad",
    ])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get("smollm_135m", smoke=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke"])


def test_chip_smoke_refuses_without_cuda():
    """Without a GPU (as here) chip_smoke exits non-zero and prints no
    result line."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_unported_routes_raise():
    """The NF4 tiled bitmap as a primary base (method="bitmap_nf4") is not
    ported yet and says so; the NF4 twin of a dense/mask base
    (QDenseWeight, ops.nf4_matmul) is, for an untransposed layer only, as
    the reference has it; the quantized plans (int8/NF4 KV, the bitmap NF4
    twin) resolve."""
    from repro_torch.core import salr
    cfg = tconfigs.get("smollm_135m", smoke=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        salr.compress_linear(gen, torch.randn(32, 32), salr.SALRConfig(method="bitmap_nf4"))
    layer = salr.compress_linear(gen, torch.randn(32, 32), salr.SALRConfig(lora_rank=2,
                                                                           res_rank=2))
    dense = dataclasses.replace(layer, base=salr.materialize_base(layer.base))
    assert isinstance(salr.attach_qbase(dense), salr.QDenseWeight)
    assert salr.attach_qbase(dataclasses.replace(dense, transposed=True)) is None
    quant = cfg.with_(kv_cache="int8", decode_kv_cache="nf4",
                      salr=dataclasses.replace(cfg.salr, decode_repr="bitmap_nf4"))
    plan = execplan.resolve_plan(quant)
    assert (plan.kv_dtype("prefill"), plan.kv_dtype("decode")) == ("int8", "nf4")
    assert (plan.base_repr("prefill"), plan.base_repr("decode")) == ("native", "bitmap_nf4")
    assert execplan.PhaseRoute("kernel", "grouped", repr="nf4").repr == "nf4"
    with pytest.raises(ValueError, match="unknown KV dtype"):
        execplan.PhaseRoute("kernel", "grouped", kv_dtype="fp8")
    plan = execplan.resolve_plan(cfg)
    assert (plan.linear_backend("prefill"), plan.kv_layout("decode")) == ("kernel", "paged")
    assert plan.linear_backend("train") == "reference"
    with execplan.plan_scope(execplan.resolve_plan(cfg, backend="reference")):
        assert execplan.current_override().linear_backend("decode") == "reference"
    assert execplan.current_override() is None
