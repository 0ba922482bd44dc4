"""The work split of the w8a8 MLP kernels on the CPU: kernels B2/B3's
walk on TMA and ``wgmma`` (``ops/fused_mlp.py:mlp_plan`` /
``mlp_work_items`` / ``up_item_steps``) and kernel B6's ``mma.sync`` walk
(``ops/megalayer.py:megalayer_plan`` / ``megalayer_work_items``), the items
in the order the kernels take their tickets.

B2/B3, at every serving shape of the flagship (widths from ``VLAConfig()``;
640 LLM tokens, two images of 261 DINOv2 and 256 so400m tokens, 512
projector tokens) at B=1 and B=4, at every gated MLP of ``LLM_BACKBONES``
(K = 896-5120) at a decode step's M = 1-4 and a 7B zoo model's prefill
rows (B=1 and 4), and at every plain MLP of the registry (the vision
towers, the projectors, Phi-2's):

* the quantization items cover each 64-row tile once, the up items each
  (row tile, panel, 128-byte step of K) exactly once, the down items each
  (128-row tile, 128 output columns, panel) exactly once;
* every item comes after the items it waits on (an up item after the
  quantization of its rows, a down item after every slice of every up item
  of the panels it reads), so a wait never depends on a ticket not yet
  taken;
* a down item's panel groups, in order, are the panels 0 .. panels - 1:
  the order the plain version sums them in;
* shared memory stays within a block's 232,448 bytes, the grid within the
  SMs and the counters within their scratch; no K is refused (the walk
  before TMA refused a plain MLP past K ~ 4,900 and streamed xq for the
  gated one past ~4,000);
* at a decode step's rows the up items split K and the down items the
  panels, so that about one item of each kind lands on every SM, and the
  up items together stream every weight byte once.

The flagship plans are pinned, and the wrapper refuses, with a ValueError
naming the shape, what its counters cannot hold. B6's tests hold its walk
as it was. The ``cuda``-marked test holds kernel B2 at K = 4096 and 5120
against its plain version on the card, bit for bit
(``tests/test_torch_fused_mlp_cuda.py`` holds the other edges).
"""

import collections

import numpy as np
import pytest
import torch

from vla_adapter_torch.core.config import Qwen2Config, VLAConfig
from vla_adapter_torch.models.registry import (
    LLM_BACKBONES,
    VISION_BACKBONES,
)
from vla_adapter_torch.models.zoo import build_vlm_config, get_zoo_entry
from vla_adapter_torch.ops.fused_mlp import (
    BLOCK_SMEM,
    COUNTER_CAP,
    DECODE_ROWS,
    K_STEP,
    SMS,
    launch_plan,
    mlp_plan,
    mlp_work_items,
    up_item_steps,
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


# --- kernels B2/B3 ------------------------------------------------------------

def _check_walk(plan, m, k, f, d):
    """The items of a B2/B3 plan in ticket order cover the work once, each
    after what it waits on, the panels summed in order; the grid fits."""
    items = mlp_work_items(plan)
    assert len(items) == (plan["quant_items"] + plan["up_items"]
                          + plan["down_items"])
    rt_rows, dt_rows = plan["row_tile"], plan["down_row_tile"]
    assert dt_rows == 2 * rt_rows
    assert plan["row_tiles"] == -(-m // rt_rows)
    assert plan["down_row_tiles"] == -(-m // dt_rows)
    assert plan["col_tiles"] == -(-d // plan["col_tile"])
    assert plan["k_steps"] == -(-k // K_STEP)
    panels = plan["panels"]
    assert panels == -(-f // plan["panel_width"])
    assert plan["last_panel_columns"] == f - (panels - 1) * plan["panel_width"]
    quant_at = {}
    up_steps = collections.Counter()
    slices = collections.Counter()
    down_cover = collections.Counter()
    groups = collections.defaultdict(list)
    for ticket, item in enumerate(items):
        if item[0] == "quant":
            assert item[1] not in quant_at
            quant_at[item[1]] = ticket
        elif item[0] == "up":
            _, rt, panel, (lo, hi) = item
            assert quant_at[rt] < ticket
            assert 0 <= lo < hi <= plan["k_steps"]
            up_steps.update((rt, panel, ks) for ks in range(lo, hi))
            slices[(rt, panel)] += 1
        else:
            _, dt, ct, order = item
            assert order and list(order) == list(range(order[0],
                                                       order[-1] + 1))
            for panel in order:
                for rt in range(2 * dt, min(2 * dt + 2, plan["row_tiles"])):
                    # every slice of the up item has an earlier ticket
                    assert slices[(rt, panel)] == plan["up_splits"]
                down_cover[(dt, ct, panel)] += 1
            groups[(dt, ct)].append(order)
    assert sorted(quant_at) == list(range(plan["row_tiles"]))
    assert set(up_steps.values()) == {1}
    assert len(up_steps) == plan["row_tiles"] * panels * plan["k_steps"]
    assert set(down_cover.values()) == {1}
    assert len(down_cover) == (plan["down_row_tiles"] * plan["col_tiles"]
                               * panels)
    for order in groups.values():
        assert [p for group in order for p in group] == list(range(panels))
    assert plan["smem_bytes"] <= BLOCK_SMEM
    assert 1 <= plan["ctas"] <= min(len(items), SMS)
    assert plan["waves"] == pytest.approx(len(items) / plan["ctas"])
    assert plan["counters"] <= COUNTER_CAP
    if m > DECODE_ROWS:
        assert plan["up_splits"] == plan["down_splits"] == 1


@pytest.mark.parametrize("shape", SHAPES, ids=_ids)
def test_mlp_items_cover_each_row_and_panel_once_in_order(shape):
    _, m, k, f, d, gated = shape
    _check_walk(mlp_plan(m, k, f, d, gated=gated), m, k, f, d)


def test_plans_take_the_devices_sm_count():
    plan = mlp_plan(640, 896, 4864, 896, gated=True, sms=16)
    assert plan["ctas"] == 16
    one_row = mlp_plan(1, 896, 4864, 896, gated=True)
    small = mlp_plan(1, 896, 4864, 896, gated=True, sms=16)
    assert one_row["ctas"] == SMS
    assert small["ctas"] == 16
    assert small["up_items"] < one_row["up_items"]
    assert small["down_items"] < one_row["down_items"]
    _check_walk(small, 1, 896, 4864, 896)


# --- every gated MLP of the registry's LLMs ---------------------------------

def _zoo_prefill_rows() -> int:
    """A 7B zoo model's prefill: one image's patches through the fused
    384-px towers (the entry's image_sequence_len) and the longest text of
    a zoo prompt (127 ids)."""
    entry = get_zoo_entry("prism-dinosiglip+7b")
    cfg = build_vlm_config(entry)
    return (cfg.vision.num_patches_per_image * entry.image_sequence_len
            + 127)


_LLM_MLPS = sorted({(c.hidden_size, c.intermediate_size)
                    for c in LLM_BACKBONES.values()
                    if isinstance(c, Qwen2Config)})
_PREFILL = _zoo_prefill_rows()
LLM_SHAPES = [(k, f, m) for k, f in _LLM_MLPS
              for m in (1, 2, 3, 4, _PREFILL, 4 * _PREFILL)]



@pytest.mark.parametrize("shape", LLM_SHAPES,
                         ids=lambda s: f"K{s[0]}-F{s[1]}-M{s[2]}")
def test_every_llm_mlp_fits_a_block(shape):
    """One path for every K: the 7B and 13B widths plan as Qwen2's does."""
    k, f, m = shape
    plan = launch_plan("w8a8_gated_mlp", m, k, f, k, gated=True)
    _check_walk(plan, m, k, f, k)


@pytest.mark.parametrize("shape", [(k, f, m) for k, f in _LLM_MLPS
                                   for m in (1, 4)],
                         ids=lambda s: f"K{s[0]}-F{s[1]}-M{s[2]}")
def test_a_decode_plan_gives_every_sm_weight_bytes(shape):
    """At a decode step's rows about one up item and one down item per SM
    (at least 3/4 of the SMs, or of the items the K steps and panels
    allow), and the up items' steps stream W1 and Wu once."""
    k, f, m = shape
    plan = mlp_plan(m, k, f, k, gated=True)
    panels, k_steps = plan["panels"], plan["k_steps"]
    assert plan["up_items"] >= 0.75 * min(SMS, panels * k_steps)
    assert plan["down_items"] >= 0.75 * min(SMS, plan["col_tiles"] * panels)
    streamed = 0
    for item in mlp_work_items(plan):
        if item[0] == "up":
            streamed += sum(cols * kbytes for _, cols, _, kbytes
                            in up_item_steps(plan, item[2], item[3]))
    assert streamed == f * k


# (M, K, F, D, activation) of every plain MLP (kernel B3) of the registry:
# each vision tower at one image's tokens, the fused projector into each
# LLM width and Phi-2's MLP at its 136-token prompt
PLAIN_MLPS = sorted(
    {(t.num_patches + t.num_prefix_tokens, t.hidden_size, t.mlp_dim,
      t.hidden_size) for v in VISION_BACKBONES.values()
     for t in (v.primary, v.fused) if t is not None}
    | {(729, 2176, 8704, d) for d in {c.hidden_size
                                       for c in LLM_BACKBONES.values()}}
    | {(136, 2560, 10240, 2560)})


@pytest.mark.parametrize("shape", PLAIN_MLPS,
                         ids=lambda s: "x".join(map(str, s)))
def test_every_plain_mlp_fits_a_block(shape):
    m, k, f, d = shape
    plan = launch_plan("w8a8_mlp", m, k, f, d, gated=False)
    _check_walk(plan, m, k, f, d)


# (M, K, F, D, gated) -> (up slices, down groups, quant, up and down
# items, CTAs, shared memory): the flagship MLPs at B=1 and 4, and Qwen2 at
# one decode row.
FLAGSHIP_PLANS = {
    (640, 896, 4864, 896, True): (1, 1, 10, 100, 35, 132, 204400),
    (522, 1024, 4096, 1024, False): (1, 1, 9, 72, 40, 121, 204416),
    (512, 1152, 4304, 1152, False): (1, 1, 8, 72, 36, 116, 204416),
    (512, 2176, 8704, 896, False): (1, 1, 8, 136, 28, 132, 204416),
    (2560, 896, 4864, 896, True): (1, 1, 40, 400, 140, 132, 204400),
    (2088, 1024, 4096, 1024, False): (1, 1, 33, 264, 136, 132, 204416),
    (2048, 1152, 4304, 1152, False): (1, 1, 32, 288, 144, 132, 204416),
    (2048, 2176, 8704, 896, False): (1, 1, 32, 544, 112, 132, 204416),
    (1, 896, 4864, 896, True): (7, 10, 1, 70, 70, 132, 204400),
}


@pytest.mark.parametrize("shape", sorted(FLAGSHIP_PLANS),
                         ids=lambda s: "x".join(map(str, s[:4])))
def test_flagship_shapes_keep_their_plan(shape):
    m, k, f, d, gated = shape
    plan = mlp_plan(m, k, f, d, gated=gated)
    assert (plan["up_splits"], plan["down_splits"], plan["quant_items"],
            plan["up_items"], plan["down_items"], plan["ctas"],
            plan["smem_bytes"]) == FLAGSHIP_PLANS[shape]


@pytest.mark.parametrize("k, f, m", [(4096, 11008, 850), (4096, 14336, 4),
                                     (5120, 13824, 1), (4304, 1152, 33)],
                         ids=lambda v: str(v))
def test_streamed_up_items_cover_each_column_and_k_chunk_once(k, f, m):
    """Both operands stream through the ring at every K now (the name is
    the one the streamed branch's test had). Over the up items of one row
    tile, the ring steps stage each (F column, 16 bytes of K) of W1 once, and in each 128-column chunk the
    steps' windows walk the item's slice of K in order (a K not a multiple
    of 128 ends in a step that TMA fills with zeros past K)."""
    plan = mlp_plan(m, k, f, k, gated=True)
    cover = np.zeros((f, -(-k // 16)), dtype=np.int64)
    for item in mlp_work_items(plan):
        if item[0] != "up" or item[1] != 0:
            continue
        lo, hi = item[3]
        windows = collections.defaultdict(list)
        for c0, cols, k0, kbytes in up_item_steps(plan, item[2], item[3]):
            windows[c0].append(k0)
            cover[c0:c0 + cols, k0 // 16:(k0 + kbytes) // 16] += 1
        for starts in windows.values():
            assert starts == [ks * K_STEP for ks in range(lo, hi)]
    assert (cover == 1).all()


def test_wrapper_refuses_what_does_not_fit_with_the_shape():
    with pytest.raises(ValueError, match=r"M=1000000, K=896, F=4864, D=896"):
        launch_plan("w8a8_gated_mlp", 10 ** 6, 896, 4864, 896, gated=True)
    # no K is refused: the plain MLP at K = 6144 and the gated at 8192
    assert launch_plan("w8a8_mlp", 512, 6144, 4096, 1024,
                       gated=False)["smem_bytes"] <= BLOCK_SMEM
    assert launch_plan("w8a8_gated_mlp", 4, 8192, 28672, 8192,
                       gated=True)["smem_bytes"] <= BLOCK_SMEM


# --- kernel B6's walk ---------------------------------------------------------

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
    quant_cover = np.zeros(m, np.int64)
    panel_cover = np.zeros((m, plan["panels"]), np.int64)
    column_cover = np.zeros((m, d), np.int64)
    last_up = {}
    for ticket, item in enumerate(items[first_ticket:], start=first_ticket):
        kind, rt = item[0], item[1]
        rows = range(rt * rt_rows, min((rt + 1) * rt_rows, m))
        if kind == "quant":
            assert rt not in ready_at
            ready_at[rt] = ticket
            quant_cover[rows.start:rows.stop] += 1
        elif kind == "up":
            assert len(rows) > 0 and ready_at[rt] < ticket
            last_up[rt] = ticket
            panel_cover[rows.start:rows.stop, item[2]] += 1
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
            column_cover[rows.start:rows.stop, cols.start:cols.stop] += 1
    if quant_cover.any():
        assert (quant_cover == 1).all()
    assert (panel_cover == 1).all()
    assert (column_cover == 1).all()


def _check_grid(plan, items):
    assert plan["smem_bytes"] <= BLOCK_SMEM
    assert 1 <= plan["ctas"] <= min(len(items),
                                    SMS * plan["ctas_per_sm"])
    assert plan["waves"] == pytest.approx(len(items) / plan["ctas"])


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


# --- on the card ------------------------------------------------------------

@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4096, 11008), (4, 4096, 14336),
                                   (_PREFILL, 4096, 11008),
                                   (2, 5120, 13824), (_PREFILL, 5120, 13824)],
                         ids=lambda s: "x".join(map(str, s)))
def test_b2_at_7b_and_13b_widths_equals_plain(device, shape):
    """Kernel B2 at the 7B and 13B widths (K = 4096-5120, which the walk
    before TMA could not hold resident), bit for bit with its plain version
    and with itself on a second call."""
    from vla_adapter_torch.models.quantize import quantize_weight
    from vla_adapter_torch.ops import cuda_lib
    from vla_adapter_torch.ops.fused_mlp import (
        GATED_KERNEL_NAME,
        fused_mlp_reference,
        w8a8_gated_mlp,
    )

    m, k, f = shape
    gen = torch.Generator(device=device).manual_seed(m + k + f)

    def weight(n, kk):
        return quantize_weight(torch.randn(n, kk, generator=gen,
                                           device=device) / kk ** 0.5)

    x = torch.randn(m, k, generator=gen, device=device).to(torch.bfloat16)
    (gq, gs), (uq, us), (dq, ds) = weight(f, k), weight(f, k), weight(k, f)
    before = cuda_lib.LAUNCHES[GATED_KERNEL_NAME]
    got = w8a8_gated_mlp(x, gq, gs, uq, us, dq, ds)
    again = w8a8_gated_mlp(x, gq, gs, uq, us, dq, ds)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES[GATED_KERNEL_NAME] == before + 2
    want = fused_mlp_reference(x, gq, gs, dq, ds, up_q=uq, up_scale=us,
                               act="silu")
    assert torch.equal(got, want), float((got.float() - want.float())
                                         .abs().max())
    assert torch.equal(again, got)
