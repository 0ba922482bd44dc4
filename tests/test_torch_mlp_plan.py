"""The work split of the w8a8 MLP panel walk (kernels B2, B3 and B6), on the
CPU: ``ops/fused_mlp.py:mlp_plan`` / ``mlp_work_items`` and
``ops/megalayer.py:megalayer_plan`` / ``megalayer_work_items``, the items in
the order the kernels take their tickets.

At every serving shape of the flagship (widths from ``VLAConfig()``; 640
LLM tokens, two images of 261 DINOv2 and 256 so400m tokens, 512 projector
tokens), at B=1 and B=4:

* the quantization items cover each row once, the up items each (row,
  panel) exactly once and the down items each (row, output column)
  exactly once;
* every item comes after the items it waits on (an up item after the
  quantization of its 32 rows, a down item after every up item of the 64
  rows it covers; in B6 an o-projection item after the attention units of
  its rows, a norm item after its rows' o-projection items, an up item
  after its row tile's norm), so a wait never depends on a ticket not yet
  taken;
* a down item sums its row tile's panels in order, 0 .. panels - 1, as
  the plain version does;
* shared memory stays within a block's 232,448 bytes, and the grid within
  the SMs.
"""

import collections

import pytest

from vla_adapter_torch.core.config import VLAConfig
from vla_adapter_torch.ops.fused_mlp import (
    BLOCK_SMEM,
    SMS,
    mlp_plan,
    mlp_work_items,
)
from vla_adapter_torch.ops.megalayer import (
    MAX_TOKENS,
    megalayer_plan,
    megalayer_work_items,
)

_CFG = VLAConfig()
_LLM = _CFG.llm
_DINO, _SIGLIP = _CFG.vision.primary, _CFG.vision.fused
_IMAGES = _CFG.vision.num_images
_LLM_TOKENS = 640

# (name, tokens per request, K, F, D, gated)
MLPS = [
    ("qwen2", _LLM_TOKENS, _LLM.hidden_size, _LLM.intermediate_size,
     _LLM.hidden_size, True),
    ("dinov2", _IMAGES * (_DINO.num_patches + _DINO.num_prefix_tokens),
     _DINO.hidden_size, _DINO.mlp_dim, _DINO.hidden_size, False),
    ("so400m", _IMAGES * (_SIGLIP.num_patches + _SIGLIP.num_prefix_tokens),
     _SIGLIP.hidden_size, _SIGLIP.mlp_dim, _SIGLIP.hidden_size, False),
    ("projector", _CFG.num_patches, _CFG.vision.embed_dim,
     4 * _CFG.vision.embed_dim, _LLM.hidden_size, False),
]
SHAPES = [(name, b * m, k, f, d, gated) for b in (1, 4)
          for name, m, k, f, d, gated in MLPS]


def _ids(shape):
    return f"{shape[0]}-M{shape[1]}"


def _check_mlp_items(plan, items, m, f, d, first_ticket, ready_at):
    """The MLP part of a ticket list from ``first_ticket`` on; ready_at[rt]
    is the ticket after which 32-row tile rt's input rows are ready (absent:
    a "quant" item of the list makes them ready)."""
    rt_rows, block_f = plan["row_tile"], plan["panel_width"]
    dt_rows = plan["down_row_tile"]
    assert dt_rows % rt_rows == 0
    assert plan["panels"] == -(-f // block_f)
    assert plan["last_panel_columns"] == f - (plan["panels"] - 1) * block_f
    ready_at = dict(ready_at)
    quant_cover = collections.Counter()
    panel_cover = collections.Counter()
    column_cover = collections.Counter()
    last_up = {}
    for ticket, item in enumerate(items[first_ticket:], start=first_ticket):
        kind, rt = item[0], item[1]
        rows = range(rt * rt_rows, min((rt + 1) * rt_rows, m))
        if kind == "quant":
            assert rt not in ready_at
            ready_at[rt] = ticket
            quant_cover.update(rows)
        elif kind == "up":
            assert len(rows) > 0 and ready_at[rt] < ticket
            last_up[rt] = ticket
            panel_cover.update((r, item[2]) for r in rows)
        else:
            assert kind == "down"
            _, _, ct, order = item
            rows = range(rt * dt_rows, min((rt + 1) * dt_rows, m))
            assert len(rows) > 0
            # every panel of the up tiles it covers has an earlier ticket
            for up_rt in {r // rt_rows for r in rows}:
                assert up_rt in last_up and last_up[up_rt] < ticket
            assert list(order) == list(range(plan["panels"]))
            cols = range(ct * plan["col_tile"],
                         min((ct + 1) * plan["col_tile"], d))
            assert len(cols) > 0
            column_cover.update((r, c) for r in rows for c in cols)
    if quant_cover:
        assert set(quant_cover.values()) == {1} and len(quant_cover) == m
    assert set(panel_cover.values()) == {1}
    assert len(panel_cover) == m * plan["panels"]
    assert set(column_cover.values()) == {1}
    assert len(column_cover) == m * d


def _check_grid(plan, items):
    assert plan["smem_bytes"] <= BLOCK_SMEM
    assert 1 <= plan["ctas"] <= min(len(items),
                                    SMS * plan["ctas_per_sm"])
    assert plan["waves"] == pytest.approx(len(items) / plan["ctas"])


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_mlp_items_cover_each_row_and_panel_once_in_order(shape):
    _, m, k, f, d, gated = shape
    plan = mlp_plan(m, k, f, d, gated=gated)
    items = mlp_work_items(plan)
    assert len(items) == (plan["quant_items"] + plan["up_items"]
                          + plan["down_items"])
    _check_mlp_items(plan, items, m, f, d, 0, {})
    _check_grid(plan, items)


@pytest.mark.parametrize("m", [_LLM_TOKENS, 4 * _LLM_TOKENS, 17, 1],
                         ids=lambda m: f"M{m}")
def test_megalayer_items_run_in_dependency_order(m):
    heads, kv_heads = _LLM.num_heads, _LLM.num_kv_heads
    d, f, dh = _LLM.hidden_size, _LLM.intermediate_size, _LLM.head_dim
    plan = megalayer_plan(m, d, heads, kv_heads, dh, f)
    items = megalayer_work_items(plan, heads, kv_heads)
    groups = heads // kv_heads
    rt_rows = plan["row_tile"]
    # attention: every (query head, 16-row block) once, within its kv head
    units = collections.Counter()
    last_unit = collections.defaultdict(lambda: -1)  # per row tile
    ticket = 0
    while ticket < len(items) and items[ticket][0] == "attention":
        _, kvh, warps = items[ticket]
        assert 1 <= len(warps) <= plan["attention_warps"]
        for head, row0 in warps:
            assert head // groups == kvh and row0 % 16 == 0 and row0 < m
            units[(head, row0)] += 1
            last_unit[row0 // rt_rows] = ticket
        ticket += 1
    assert ticket == plan["attention_items"]
    assert set(units.values()) == {1}
    assert len(units) == heads * -(-m // 16) == plan["attention_units"]
    # the o-projection items of each row tile (one per 128 columns of D)
    # after every attention unit of its rows, then each tile's norm after
    # its o-projection items
    columns = collections.Counter()
    last_oproj = {}
    while items[ticket][0] == "oproj":
        _, rt, ct = items[ticket]
        assert last_unit[rt] < ticket
        columns.update(range(ct * plan["col_tile"],
                             min((ct + 1) * plan["col_tile"], d)))
        last_oproj[rt] = ticket
        ticket += 1
    assert set(columns.values()) == {plan["row_tiles"]} and len(columns) == d
    ready_at = {}
    for rt in range(plan["row_tiles"]):
        assert items[ticket] == ("norm", rt)
        assert last_oproj[rt] < ticket
        ready_at[rt] = ticket
        ticket += 1
    _check_mlp_items(plan, items, m, f, d, ticket, ready_at)
    _check_grid(plan, items)


def test_megalayer_plan_fills_shared_memory_with_attention_warps():
    """At the Qwen2 layer five warps' scores (40 KB each at 640 keys) fit
    beside the ring; at MAX_TOKENS one still does."""
    d, f = _LLM.hidden_size, _LLM.intermediate_size
    plan = megalayer_plan(_LLM_TOKENS, d, _LLM.num_heads, _LLM.num_kv_heads,
                          _LLM.head_dim, f)
    assert plan["attention_warps"] == 5
    for dh in (16, 32, 64, 128):
        wide = megalayer_plan(MAX_TOKENS, d, 8, 1, dh, f)
        assert wide["attention_warps"] >= 1
        assert wide["smem_bytes"] <= BLOCK_SMEM


def test_plans_take_the_devices_sm_count():
    plan = mlp_plan(640, 896, 4864, 896, gated=True, sms=16)
    assert plan["ctas"] == 16 * plan["ctas_per_sm"]
    one_row = mlp_plan(1, 896, 4864, 896, gated=True)
    assert one_row["ctas"] == 1 + one_row["up_items"] + 7
