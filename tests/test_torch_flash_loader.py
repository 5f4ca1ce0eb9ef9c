"""Flash attention's bf16 kernel on the CPU: which loader the wrapper
chooses for it, and the work of row 12c, the dense GQA prefill that
``chip_smoke.py`` times beside SDPA.

The kernel loads Q, K and V by TMA where a tensor map can describe every
row (rows of a multiple of 16 bytes at 16-byte aligned bases), and by its
producer warpgroup's threads otherwise; ``ops.loader`` decides from the
head dims and the operands' addresses alone, so its choice is checked
here with explicit addresses, no card."""

import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import registry
from repro_torch.kernels.flash_attention import flash_attention, ops
from repro_torch.models import transformer

ATTENTION_KINDS = ("attn", "local", "mla")


def _prefill_dims(cfg):
    """(D, Dv) of the flash attention calls of a config's prefill: q and
    k of qk_nope + qk_rope against v of v_head under MLA, else the head
    dim (d_model / n_heads where the config gives none)."""
    if cfg.qk_nope_dim or cfg.qk_rope_dim:
        return cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim
    d = cfg.head_dim or cfg.d_model // cfg.n_heads
    return d, d


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_served_prefills_take_the_tma_loader(arch):
    """Every config's prefill reaches the kernel with rows TMA can load:
    at the addresses of fresh allocations (256-byte aligned) and at any
    16-byte aligned base.  xlstm-350m has no attention layer, so its
    prefill never calls flash attention."""
    cfg = get_config(arch)
    kinds = {k for k, _ in transformer.unrolled_sigs(cfg)}
    if arch == "xlstm-350m":
        assert not kinds & set(ATTENTION_KINDS)
        return
    assert kinds & set(ATTENTION_KINDS)
    D, Dv = _prefill_dims(cfg)
    assert 0 < D <= 256 and 0 < Dv <= 256
    for base in (0, 256, 1 << 20, 48):
        assert ops.loader(D, Dv, base, base + 4096, base + 8192) == "tma"
    # meta tensors of the prefill's shapes pass the wrapper's operand
    # checks and give null addresses: TMA
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta")
               for s in ((1, cfg.n_heads, 16, D), (1, cfg.n_kv_heads, 16, D),
                         (1, cfg.n_kv_heads, 16, Dv)))
    ptrs = registry.pointers((q, torch.bfloat16, "q"),
                             (k, torch.bfloat16, "k"),
                             (v, torch.bfloat16, "v"))[:-1]
    assert ops.loader(D, Dv, *ptrs) == "tma"


@pytest.mark.parametrize("D,Dv,offset,want", [
    (100, 100, 0, "threads"),   # 200-byte rows: not a multiple of 16
    (40, 20, 0, "threads"),     # v's 40-byte rows
    (64, 64, 2, "threads"),     # a base 2 bytes off alignment
    (64, 64, 8, "threads"),     # 8 bytes off
    (40, 24, 0, "tma"),         # 80- and 48-byte rows, aligned
    (256, 256, 16, "tma"),      # 16-byte aligned is enough
], ids=["D100", "Dv20", "offset2", "offset8", "D40_Dv24", "offset16"])
def test_loader_choice(D, Dv, offset, want):
    assert ops.loader(D, Dv, 4096, 8192 + offset, 12288) == want
    assert ops.loader(D, Dv, 4096 + offset, 8192, 12288) == want
    assert ops.LOADERS[want] in (0, 1)


def test_a_base_two_bytes_off_is_seen_from_the_tensor():
    """A view one bf16 element into its storage has a base 2 bytes off
    the allocation's alignment: the threads loader."""
    buf = torch.zeros(1 + 2 * 8 * 64, dtype=torch.bfloat16)
    q = buf[1:].view(1, 2, 8, 64)
    assert q.data_ptr() % 16 == 2
    assert ops.loader(64, 64, q.data_ptr(), q.data_ptr(), q.data_ptr()) == \
        "threads"
    assert ops.loader(64, 64, buf.data_ptr(), buf.data_ptr(),
                      buf.data_ptr()) == "tma"


def test_plain_path_counts_no_loader():
    """On the CPU the wrapper runs the plain version: no launch, and no
    loader counted."""
    ops.reset_loaders()
    q = torch.randn(1, 2, 5, 16).to(torch.bfloat16)
    flash_attention(q, q, q)
    assert ops.loader_launches == {"tma": 0, "threads": 0}


def test_block_is_the_compiled_tile():
    spec = registry.get("flash_attention")
    assert spec.block_args == ("bq", "bk")
    assert spec.block_space == ((ops.BLOCK_Q, ops.block_k(128)),)
    assert spec.default_block == (128, 128)
    assert [ops.block_k(d) for d in (64, 96, 128, 192, 200, 256)] == \
        [128, 128, 128, 128, 64, 64]


# Row 12c: llama3.2-3b's prefill of one 2048-token prompt in bf16, 24 query
# heads on 8 kv heads of dim 128, causal: 2,098,176 live pairs a head, 2
# (D + Dv) = 512 flops each, so 25,782,386,688 flops; q and the output 12.58
# MB each, k and v 4.19 MB each, 33,554,432 bytes; 0.0261 ms on the bf16
# tensor cores against 0.0100 ms for the bytes.
def test_row_12c_work():
    cfg = get_config("llama3.2-3b")
    H, Hkv, D, S = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 2048
    assert (H, Hkv, D) == (24, 8, 128)
    spec = registry.get("flash_attention")
    q, k, v = (torch.empty(s, dtype=torch.bfloat16, device="meta")
               for s in ((1, H, S, D), (1, Hkv, S, D), (1, Hkv, S, D)))
    args = (q, k, v, {"causal": True}, None)
    assert ops.live_pairs(S, S, causal=True) == 2_098_176
    assert spec.flops(*args) == 25_782_386_688
    assert spec.nbytes(*args) == 33_554_432
    ms, by = spec.bound_ms(*args)
    assert by == "operations"
    assert ms == pytest.approx(25_782_386_688 / 989e12 * 1e3)
    assert round(ms, 4) == 0.0261
