"""The frozen arithmetic (``work.py``) against the program's own count of
a forward's dot FLOPs on meta tensors (``repro_torch.roofline.op_count``),
and its items at the cells' sizes.

The two define two terms differently.  The program's plain lowerings
compute every (query, key) pair of attention and of the SSD's within-chunk
term and mask the upper triangle away, and the counter counts what they
compute; ``work.py`` counts the pairs the inputs need (the causal
triangle, diagonal included).  The test adds the masked pairs back and
then wants the two counts equal.  Those pairs are each family's own, so the
test names its configurations: a new family brings its own such test, in a
new file."""

import pytest
import torch

from portbench import cells, work


def _masked_pairs_flops(cfg, b, s):
    if cfg["family"] == "dense_decoder":
        d = cfg["hidden_size"]
        hq = cfg["num_attention_heads"]
        hd = cfg.get("head_dim") or d // hq
        per_layer = 4 * b * hq * hd * (s * s - s * (s + 1) // 2)
        return per_layer * cfg["num_hidden_layers"]
    q = min(cfg["chunk_size"], s)
    heads = cfg["expand"] * cfg["d_model"] // cfg["headdim"]
    per_layer = 2 * b * heads * (s // q) * (q * q - q * (q + 1) // 2) \
        * (cfg["d_state"] + cfg["headdim"])
    return per_layer * cfg["n_layer"]


@pytest.mark.parametrize("name,b,s", [
    ("yi-6b", 2, 32), ("yi-6b", 1, 48),
    ("mamba2-370m", 2, 32), ("mamba2-370m", 3, 16)])
def test_model_flops_match_the_programs_count_on_meta(tiny_config, name, b,
                                                      s):
    from repro_torch.core.hero import offload_policy
    from repro_torch.models import build_model
    from repro_torch.roofline.op_count import count_ops

    cfg = tiny_config(name)
    model = build_model(cells.port_arch(cfg))
    tokens = torch.empty((b, s), dtype=torch.int64, device="meta")
    with offload_policy(mode="device", use_kernels=False), torch.no_grad(), \
            count_ops() as counter:
        model.forward(model.param_specs(), tokens)
    counted = counter.total().dot_flops
    assert counted == work.model_flops(cfg, b, s) \
        + _masked_pairs_flops(cfg, b, s)


def test_items_at_the_cells_sizes():
    yi = cells.load_cell("yi-6b.prefill-4k")
    items = work.forward_work(yi.config, 4, 4096)
    assert [i["family"] for i in items].count("gemm") == 32 * 5 + 1
    attn = [i for i in items if i["family"] == "attention"]
    assert len(attn) == 32
    assert attn[0]["flops"] == 4 * 4 * 32 * (4096 * 4097 // 2) * 128
    assert work.model_flops(yi.config, 4, 4096) == pytest.approx(2.08e14,
                                                                 rel=0.01)
    head = items[-1]
    assert head["flops"] == 2 * 16384 * 4096 * 64000
    assert head["bytes"] == (16384 * 4096 + 4096 * 64000
                             + 16384 * 64000) * 2
    mamba = cells.load_config("mamba2-370m")
    items = work.forward_work(mamba, 16, 2048)
    ssd = [i for i in items if i["family"] == "ssd"]
    assert len(ssd) == 48 and ssd[0]["dtype"] == "bfloat16"
    # x and y a head, B and C once for the one group of 32 heads, in
    # bf16; the log-decays a head in f32.
    rows = 16 * 8 * 256
    assert ssd[0]["bytes"] == 2 * rows * (2 * 32 * 64 + 2 * 128) \
        + 4 * rows * 32
    assert ssd[0]["flops"] == 2 * 16 * 32 * 8 * (256 * 257 // 2) \
        * (128 + 64)
    assert [i["family"] for i in items].count("gemm") == 48 * 6 + 1
    assert items[-1]["flops"] == 2 * 32768 * 1024 * 50288


def test_ideal_time_takes_the_larger_bound():
    mm = work.gemm("x", 16384, 4096, 4096)
    assert work.ideal_seconds(mm) == mm["flops"] / work.PEAKS["bfloat16"]
    thin = work.gemm("x", 1, 4096, 4096)
    assert work.ideal_seconds(thin) == \
        thin["bytes"] / work.PEAKS["hbm_bytes_per_s"]
