"""``flash_attention`` with per-row key counts (``kv_lens``) and a page
table: the serving engine's slotted and paged cache reads. This file imports
no JAX, so its card tests run on a machine without it:

  PYTHONPATH=src python -m pytest -q -p no:cacheprovider --noconftest -k cuda \
      tests/test_torch_paged_attention.py

On the CPU: the plain version read through a page table equals the plain
version on the pages gathered into a contiguous cache (bit for bit: the
same float32 operations on the same values), a ragged call equals one call
per row, the wrapper checks the new arguments, and
``layers.cache_index`` clamps logical pages past the table and sends
masked writes to the sink page on the host.

On the card (``test_cuda_*``): the decode kernel (bf16, at most 16 packed
rows), the tensor-core kernel (bf16 multi-token paged steps with more than
16 packed rows) and the FMA kernel (a float32 cache under bf16 queries,
float32) read through page tables of page length 1, 3, 16 and 256 with
pages out of order, ragged lengths down to 1, a free lane whose table is
all sink, windows and a softcap, against the plain version: bf16 within
one bf16 ulp of each output row's scale plus 2^-7 relative and 2^-11
relative RMS, float32 within 1e-5 (both compute in float32 and round
once). Two calls give the same bits; each row gives the same bits paged as
from a contiguous copy of its keys with the same ``kv_lens``; the C entry
takes a page table, ``kv_lens`` and a split KV range for the tensor-core
kernel.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.models import layers

F32_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the plain version's tensors are small, and the
    suite runs several test workers side by side."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    return torch.device("cuda")


def _paged(seed, b, h, kv, sq, lens, hd, page_len, q_dtype=torch.bfloat16,
           kv_dtype=torch.bfloat16, free_lane=True, device="cpu"):
    """q (B, H, Sq, hd), arenas (P, page_len, KV, hd) whose pages are handed
    out in a random order, page tables with sink entries past each row's
    pages, kv_lens, max_kv_len. With ``free_lane`` the last row is a free
    lane: an all-sink table and Sq keys, as the engine's free lanes."""
    rng = np.random.default_rng(seed)
    lens = list(lens)
    if free_lane:
        lens[-1] = sq
    max_pages = -(-max(lens) // page_len)
    need = [0 if (free_lane and r == b - 1) else -(-n // page_len) for r, n in enumerate(lens)]
    n_phys = sum(need) + 3                   # two pages nobody maps, then the sink
    sink = n_phys - 1
    order = rng.permutation(n_phys - 1)
    table = np.full((b, max_pages), sink, np.int32)
    at = 0
    for r in range(b):
        table[r, :need[r]] = order[at:at + need[r]]
        at += need[r]
    q = torch.from_numpy(rng.standard_normal((b, h, sq, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((n_phys, page_len, kv, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((n_phys, page_len, kv, hd)).astype(np.float32))
    return dict(q=q.to(device, q_dtype), k=k.to(device, kv_dtype), v=v.to(device, kv_dtype),
                page_table=torch.from_numpy(table).to(device),
                kv_lens=torch.tensor(lens, dtype=torch.int32, device=device),
                max_kv_len=max(lens))


def _contiguous(case):
    """The same keys gathered into a (B, KV, max_kv_len, hd) cache."""
    n = case["max_kv_len"]
    return (tref.gather_pages(case["k"], case["page_table"], n).contiguous(),
            tref.gather_pages(case["v"], case["page_table"], n).contiguous())


def _close(got, want):
    """bfloat16: one bf16 ulp of each (b, h, i) row's scale plus 2^-7
    relative, and 2^-11 relative RMS over the output. float32: F32_TOL."""
    if want.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        row = w.abs().amax(dim=-1, keepdim=True)
        rel_rms = float((g - w).pow(2).mean().sqrt() / w.pow(2).mean().sqrt())
        return (bool(((g - w).abs() <= 2.0 ** -8 * row + 2.0 ** -7 * w.abs()).all())
                and rel_rms <= 2.0 ** -11)
    return bool(((got - want).abs() <= F32_TOL["atol"] + F32_TOL["rtol"] * want.abs()).all())


# --- CPU ----------------------------------------------------------------------

@pytest.mark.parametrize("page_len", [1, 3, 16])
def test_plain_paged_equals_plain_on_gathered_pages(page_len):
    case = _paged(page_len, 3, 4, 2, 2, [7, 19, 1], 16, page_len, torch.float32,
                  torch.float32)
    kw = dict(causal=True, window=5, softcap=20.0, scale=0.3)
    got = ops.flash_attention(case["q"], case["k"], case["v"], kv_lens=case["kv_lens"],
                              page_table=case["page_table"], max_kv_len=case["max_kv_len"],
                              **kw)
    kc, vc = _contiguous(case)
    want = tref.flash_attention_ref(case["q"], kc, vc, kv_lens=case["kv_lens"], **kw)
    assert torch.equal(got, want)


def test_plain_ragged_equals_one_call_per_row():
    case = _paged(7, 3, 4, 2, 3, [5, 12, 9], 8, 4, torch.float32, torch.float32,
                  free_lane=False)
    kc, vc = _contiguous(case)
    got = tref.flash_attention_ref(case["q"], kc, vc, kv_lens=case["kv_lens"], window=4)
    for r, n in enumerate(case["kv_lens"].tolist()):
        want = tref.flash_attention_ref(case["q"][r:r + 1], kc[r:r + 1, :, :n],
                                        vc[r:r + 1, :, :n], window=4)
        np.testing.assert_allclose(got[r:r + 1].numpy(), want.numpy(), **F32_TOL)


def test_wrapper_checks_paged_arguments():
    case = _paged(1, 2, 4, 2, 1, [5, 9], 8, 4, torch.float32, torch.float32)
    q, k, v = case["q"], case["k"], case["v"]
    lens, table = case["kv_lens"], case["page_table"]
    with pytest.raises(ValueError, match="needs kv_lens"):
        ops.flash_attention(q, k, v, page_table=table, max_kv_len=9)
    with pytest.raises(ValueError, match="max_kv_len"):
        ops.flash_attention(q, k, v, kv_lens=lens, page_table=table)
    with pytest.raises(ValueError, match="int32"):
        ops.flash_attention(q, k, v, kv_lens=lens, page_table=table.long(), max_kv_len=9)
    with pytest.raises(ValueError, match="pages must follow"):
        ops.flash_attention(q, k[:, :2], v[:, :2], kv_lens=lens, page_table=table,
                            max_kv_len=9)
    kc, vc = _contiguous(case)
    with pytest.raises(ValueError, match="exceeds"):
        ops.flash_attention(q, kc, vc, kv_lens=lens, max_kv_len=99)


def test_decode_path_of_an_arena():
    """An arena (P, page_len, KV, hd) gives its KV heads explicitly."""
    q = torch.zeros((2, 32, 1, 120), dtype=torch.bfloat16)
    arena = torch.zeros((5, 16, 8, 120), dtype=torch.bfloat16)
    assert fa.decode_path(q, arena, arena, kv_heads=8)
    assert not fa.decode_path(q.expand(2, 32, 8, 120).contiguous(), arena, arena, kv_heads=8)
    assert not fa.decode_path(q, arena.float(), arena.float(), kv_heads=8)


def test_cache_index_clamps_and_masks_on_the_host():
    """A logical page past the table takes its last entry (the reference's
    gather clamps); masked positions write to the sink; a slotted write past
    the cache raises instead of faulting on the device."""
    table = np.array([[4, 2], [1, 5]], np.int32)
    idx = layers.cache_index(np.array([3, 0]), 2, 4, "cpu", page_table=table,
                             write_mask=np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool),
                             page_len=2, sink=6)
    # row 0: positions 3..6 -> pages 2, 2, clamp 2, masked sink
    assert idx.write_rows.tolist() == [2 * 2 + 1, 2 * 2 + 0, 2 * 2 + 1, 6 * 2 + 0,
                                       1 * 2 + 0, 1 * 2 + 1, 6 * 2 + 0, 6 * 2 + 1]
    assert idx.kv_lens.tolist() == [7, 4] and idx.max_kv_len == 7
    assert idx.positions.tolist() == [[3, 4, 5, 6], [0, 1, 2, 3]]
    assert idx.page_table.dtype == torch.int32 and idx.page_table.tolist() == table.tolist()
    slotted = layers.cache_index([2, 0], 2, 1, "cpu", s_max=5)
    assert slotted.write_rows.tolist() == [2, 5] and slotted.page_table is None
    with pytest.raises(ValueError, match="outside"):
        layers.cache_index([2, 5], 2, 1, "cpu", s_max=5)


# --- card ---------------------------------------------------------------------

# (name, B, H, KV, Sq, lens, hd, page_len, q dtype, kv dtype, window, softcap,
#  kernel): the engine's steps at small and h2o-danube widths.
CARD_CASES = [
    ("decode_bf16_p1", 3, 32, 8, 1, [1, 40, 17], 120, 1, "bfloat16", "bfloat16", 0, 0.0, "decode"),
    ("decode_bf16_p3_window", 4, 32, 8, 1, [5, 301, 77, 3], 120, 3, "bfloat16", "bfloat16", 64,
     0.0, "decode"),
    ("decode_bf16_p16_softcap", 3, 16, 8, 1, [1, 999, 130], 128, 16, "bfloat16", "bfloat16",
     256, 50.0, "decode"),
    ("decode_bf16_p256_long", 8, 32, 8, 1, [4097, 4100, 1, 2000, 4111, 256, 257, 9], 120, 256,
     "bfloat16", "bfloat16", 4096, 0.0, "decode"),
    ("decode_sq4_bf16_p16", 3, 32, 8, 4, [4, 50, 700], 120, 16, "bfloat16", "bfloat16", 0, 0.0,
     "decode"),
    ("decode_f32cache_p16", 3, 32, 8, 1, [1, 333, 1200], 120, 16, "bfloat16", "float32", 512,
     0.0, "fma"),
    ("decode_f32_p3_softcap", 2, 8, 2, 1, [7, 100], 64, 3, "float32", "float32", 0, 30.0, "fma"),
    ("multi_bf16_p256", 4, 32, 8, 8, [2120, 8, 600, 4000], 120, 256, "bfloat16", "bfloat16",
     4096, 0.0, "tensor_cores"),
    ("multi_bf16_p1_window", 3, 8, 2, 9, [9, 30, 12], 64, 1, "bfloat16", "bfloat16", 7, 0.0,
     "tensor_cores"),
    ("multi_f32cache_p16", 3, 32, 8, 5, [5, 900, 64], 120, 16, "bfloat16", "float32", 0, 0.0,
     "fma"),
    ("multi_f32_p3_softcap", 2, 4, 2, 33, [40, 100], 32, 3, "float32", "float32", 0, 25.0,
     "fma"),
]


@pytest.mark.parametrize("case", CARD_CASES, ids=[c[0] for c in CARD_CASES])
def test_cuda_paged_kernel_matches_plain(cuda, case):
    (name, b, h, kv, sq, lens, hd, page_len, qd, kvd, window, softcap, kernel) = case
    pc = _paged(len(name) * 7919, b, h, kv, sq, lens, hd, page_len, getattr(torch, qd),
                getattr(torch, kvd), device=cuda)
    kw = dict(causal=True, window=window, softcap=softcap, kv_lens=pc["kv_lens"],
              max_kv_len=pc["max_kv_len"])
    counter = dict(decode="decode_launches", tensor_cores="tensor_core_launches",
                   fma="fma_launches")[kernel]
    before = (getattr(ops.flash_attention, counter), ops.flash_attention.paged_launches)
    got = ops.flash_attention(pc["q"], pc["k"], pc["v"], page_table=pc["page_table"], **kw)
    again = ops.flash_attention(pc["q"], pc["k"], pc["v"], page_table=pc["page_table"], **kw)
    want = tref.flash_attention_ref(pc["q"], pc["k"], pc["v"], page_table=pc["page_table"],
                                    **kw)
    kc, vc = _contiguous(pc)
    flat = ops.flash_attention(pc["q"], kc, vc, **kw)
    torch.cuda.synchronize()
    assert (getattr(ops.flash_attention, counter), ops.flash_attention.paged_launches) == (
        before[0] + 3, before[1] + 2)
    assert got.dtype == pc["q"].dtype and bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert torch.equal(got, flat), "a row's bits depend on where its keys lie"
    assert _close(got, want), float((got.float() - want.float()).abs().max())


# (name, B, Sq, lens, runs): h2o-danube's heads (32 over 8, hd 120), pages
# of 256 in random order, window 4,096; the last row a free lane. A verify
# step's 8 queries are 32 packed rows (one row tile); 100 queries are 400
# (four row tiles, the last with 16 rows), some rows fewer keys than Sq.
TC_PAGED_CASES = [
    ("verify_one_row_tile", 3, 8, [2100, 2200, 0], 4),
    ("ragged_four_row_tiles", 4, 100, [2100, 700, 60, 0], 3),
]


@pytest.mark.parametrize("case", TC_PAGED_CASES, ids=[c[0] for c in TC_PAGED_CASES])
def test_cuda_tensor_core_kernel_takes_paged_calls(cuda, case):
    """The C entry's tensor-core kernel (kernel 1) with a page table,
    kv_lens and the KV range split in runs: within ``_close`` of the plain
    version, the same bits as on the same keys gathered into a contiguous
    cache, and the same bits twice."""
    name, b, sq, lens, runs = case
    pc = _paged(3, b, 32, 8, sq, lens, 120, 256, device=cuda)
    q, k, v = pc["q"], pc["k"], pc["v"]
    kw = dict(causal=True, window=4096, softcap=0.0, scale=0.1, kv_lens=pc["kv_lens"])
    kc, vc = _contiguous(pc)
    n = pc["max_kv_len"]

    def call(kk, vv, table):
        out = torch.empty_like(q)
        return fa.launch(q, kk, vv, out, 8, n, fa.TENSOR_CORES, runs, page_table=table, **kw)
    before = ops.flash_attention.tensor_core_launches
    got = call(k, v, pc["page_table"])
    again = call(k, v, pc["page_table"])
    flat = call(kc, vc, None)
    want = tref.flash_attention_ref(q, k, v, page_table=pc["page_table"], max_kv_len=n, **kw)
    torch.cuda.synchronize()
    assert ops.flash_attention.tensor_core_launches == before + 3
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, again)
    assert torch.equal(got, flat), "a row's bits depend on where its keys lie"
    assert _close(got, want), float((got.float() - want.float()).abs().max())
