"""granite-4.0-h's frozen arithmetic (``work_granitemoehybrid.py``)
against the program's own count of a forward's dot FLOPs on meta tensors
(``repro_torch.roofline.op_count``), and its items at the cell's sizes.

As in ``test_portbench_work.py``: the program's plain lowerings compute
every (query, key) pair of attention and of the SSD's within-chunk term and
mask the upper triangle away, and ``work`` counts the causal triangle, so
the test adds the masked pairs back.  The routed experts' products count
2·R·d·f a projection over the R = T·k routed rows in both, whatever the
routing."""

import pytest
import torch

from portbench import cells, work


def _masked_pairs_flops(cfg, b, s):
    kinds = cfg["layer_types"]
    hq, hd = cfg["num_attention_heads"], cfg["head_dim"]
    attn = 4 * b * hq * hd * (s * s - s * (s + 1) // 2)
    q = min(cfg["mamba_chunk_size"], s)
    heads = cfg["mamba_expand"] * cfg["hidden_size"] // cfg["mamba_d_head"]
    ssd = 2 * b * heads * (s // q) * (q * q - q * (q + 1) // 2) \
        * (cfg["mamba_d_state"] + cfg["mamba_d_head"])
    return sum(attn if k == "attention" else ssd for k in kinds)


@pytest.mark.parametrize("b,s", [(2, 32), (1, 48)])
def test_model_flops_match_the_programs_count_on_meta(tiny_config, b, s):
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model
    from repro_torch.roofline.op_count import count_ops

    cfg = tiny_config("granite-4.0-h-small")
    model = build_model(cells.port_arch(cfg))
    tokens = torch.empty((b, s), dtype=torch.int64, device="meta")
    with offload_policy(mode="device", use_kernels=False), torch.no_grad(), \
            count_ops() as counter:
        model.forward(model.param_specs(), tokens)
    counted = counter.total().dot_flops
    assert counted == work.model_flops(cfg, b, s) \
        + _masked_pairs_flops(cfg, b, s)


def test_items_at_the_cells_sizes():
    cfg = cells.load_cell("granite-4.0-h-small.prefill-4k").config
    items = work.forward_work(cfg, 4, 4096)
    fams = [i["family"] for i in items]
    assert fams.count("attention") == 2 and fams.count("ssd") == 18
    assert fams.count("expert_gemm") == 3 * 20
    # 18 mixers x 6 GEMMs, 2 attention layers x 2, 20 x (router + shared
    # expert's 3), the head.
    assert fams.count("gemm") == 18 * 6 + 2 * 2 + 20 * 4 + 1
    rows = 16384 * 10
    gate = [i for i in items if i["name"] == "expert_gate"][0]
    assert gate["flops"] == 2 * rows * 4096 * 768
    assert gate["bytes"] == 2 * (rows * 4096 + 72 * 4096 * 768 + rows * 768)
    down = [i for i in items if i["name"] == "expert_down"][0]
    assert down["flops"] == gate["flops"]
    ssd = [i for i in items if i["family"] == "ssd"][0]
    assert ssd["flops"] == 2 * 4 * 128 * 16 * (256 * 257 // 2) * (128 + 64)
    head = items[-1]
    assert head["name"] == "head" and head["flops"] == 2 * 16384 * 4096 * 100352
    # About 155 TFLOP a forward, most of it the routed experts and the
    # Mamba projections.
    total = work.model_flops(cfg, 4, 4096)
    assert total == pytest.approx(1.55e14, rel=0.02)
    experts = sum(i["flops"] for i in items if i["family"] == "expert_gemm")
    assert experts == pytest.approx(6.18e13, rel=0.01)
