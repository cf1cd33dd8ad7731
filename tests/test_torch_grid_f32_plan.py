"""The f32 grid forwards' step product (csrc/rnn.cuh grid_f32_product and
GridF32Plan; the GRU's and the LSTM's forward above H = 256 in f32), on
the CPU: the plan that `gru.grid_f32_plan` computes, and that the C side
computes again and checks against the wrapper's `smem_bytes`, for every
width the grid layout takes and the batch shapes at its edges. The kernels
themselves are held against their plain versions on the card
(tests/test_torch_kernels.py, `-k "gru_grid_forward or lstm_grid_forward"`,
and chip_smoke.py phases u and v)."""

import re
from pathlib import Path

import pytest
import torch

from seqrec_tpu_torch.ops.cuda import gru as cuda_gru
from seqrec_tpu_torch.ops.cuda import lstm as cuda_lstm

RNN_CUH = Path(__file__).resolve().parents[1] / "seqrec_tpu_torch" / "csrc" / "rnn.cuh"
CELLS = {"gru": (cuda_gru, 3), "lstm": (cuda_lstm, 4)}
BATCHES = (1, 3, 4, 5, 128, 256)


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_grid_f32_plan_takes_every_width(cell, B):
    """Every H % 4 == 0 from 260 to 1,056 (grid_max_hidden(float32), which
    stays 1,056): the f32 forward runs the grid layout with the plan of its
    row group's rows (both variants: the reset one is the kernel's template
    flag, launched with the same plan); W_h and the ring (or the partial sums, whose bytes it
    shares) fit SMEM_LIMIT; the 8 warps are row warps x K slices; the blocks
    cover the row group's rows, none empty; the K slicing (4 slices of
    GRID_F32_SPAN columns a chunk) is the same at every shape, so that a
    row's bits do not depend on its batch; K whole chunks; at least two stages and no more than a
    step's chunks; the gate math's pairs (32 rows a slot) fit the kernel's
    8 slots."""
    mod, gates = CELLS[cell]
    limit = mod.grid_max_hidden(torch.float32)
    assert limit == 1056
    for H in range(260, limit + 1, 4):
        cfg = mod.launch_config(B, 50, H, H, torch.float32)
        assert cfg["layout"] == "grid", (H, B)
        rows, kp = cfg["rows_per_group"], cfg["k_padded"]
        plan = cuda_gru.grid_f32_plan(rows, kp, gates)
        assert {k: cfg[k] for k in plan} == plan, (H, B)
        block, ks, chunk, stages = plan["ring_rows"], plan["k_split"], plan["chunk"], plan["stages"]
        weights = 32 * gates * kp
        ring = stages * block * (chunk + 4) * 4
        red = ks * block * (8 * gates + 4) * 4
        assert cfg["smem_bytes"] == weights + max(ring, red) <= cuda_gru.SMEM_LIMIT, (H, B)
        # A warp is 8 row lanes of thread_rows rows; its row warps x K slices are the 8 warps.
        warp_rows = 8 * plan["thread_rows"]
        assert block % warp_rows == 0 and block // warp_rows * ks == cuda_gru.GRID_THREADS // 32
        assert block in (32, 64, 128) and (block >= rows or block == 128)
        assert plan["row_blocks"] * block >= rows > (plan["row_blocks"] - 1) * block
        # The K slicing is the same at every shape: a row's bits whatever its batch.
        assert (ks, chunk) == (cuda_gru.GRID_F32_K_SPLIT, cuda_gru.GRID_F32_SPAN * ks) == (4, 64)
        assert kp % chunk == 0
        assert 2 <= stages <= min(kp // chunk, cuda_gru.GRID_F32_MAX_STAGES)
        assert block // 32 <= 8  # the gate math's pairs a thread
        # A barrier counter a row group, within the workspace's counter bytes.
        assert cfg["row_groups"] * cuda_gru.GRID_F32_COUNTER_STRIDE <= cuda_gru.GRID_COUNTER
        # One more stage would not fit, or the step has no more chunks.
        assert (stages == min(kp // chunk, cuda_gru.GRID_F32_MAX_STAGES)
                or weights + (stages + 1) * block * (chunk + 4) * 4 > cuda_gru.SMEM_LIMIT)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_grid_f32_plan_at_the_paths_shapes(cell):
    """The plans at the shapes the main paths run: the wide step (B=256,
    T=200, D=H=512: two row groups of 128 rows, 8 rows a thread), rsc15's
    reset shape with 1,000 units (B=256: one group of 256 rows, two blocks
    of 128) and ml1m_lstm's reset shape (B=128, H=512: 64 rows, 4 a thread);
    and a row group of 4 rows (B = 5), 2 rows a thread in a block of 32;
    each in four K slices of 64-column chunks."""
    mod, gates = CELLS[cell]
    wide = mod.launch_config(256, 200, 512, 512, torch.float32)
    assert (wide["grid"], wide["rows_per_group"], wide["ring_rows"], wide["thread_rows"],
            wide["k_split"], wide["chunk"], wide["stages"]) == (128, 128, 128, 8, 4, 64,
                                                                5 if gates == 3 else 4)
    h1000 = mod.launch_config(256, 50, 1000, 1000, torch.float32)
    assert (h1000["grid"], h1000["ring_rows"], h1000["row_blocks"], h1000["k_split"],
            h1000["chunk"]) == (125, 128, 2, 4, 64)
    ml1m = mod.launch_config(128, 200, 512, 512, torch.float32)
    assert (ml1m["rows_per_group"], ml1m["ring_rows"], ml1m["thread_rows"], ml1m["k_split"],
            ml1m["chunk"]) == (64, 64, 4, 4, 64)
    tiny = mod.launch_config(5, 2, 516, 516, torch.float32)
    assert (tiny["rows_per_group"], tiny["ring_rows"], tiny["thread_rows"], tiny["k_split"],
            tiny["chunk"]) == (4, 32, 2, 4, 64)
    # Past 128 rows a group the CTA walks blocks of 128 rows.
    many = mod.launch_config(600, 5, 1056, 1056, torch.float32)
    assert (many["row_groups"], many["rows_per_group"], many["ring_rows"],
            many["row_blocks"]) == (1, 600, 128, 5)


def test_grid_f32_plan_raises_outside_it():
    """No plan where two stages of the ring do not fit beside W_h (K past
    the grid layout's f32 limit in the LSTM at 256 rows), for an empty row
    group, or for K not a multiple of 128."""
    with pytest.raises(ValueError, match="no plan"):
        cuda_gru.grid_f32_plan(256, 1280, 4)
    with pytest.raises(ValueError, match="no plan"):
        cuda_gru.grid_f32_plan(0, 512, 3)
    with pytest.raises(ValueError, match="no plan"):
        cuda_gru.grid_f32_plan(128, 500, 3)
    # The bf16 forwards and every reverse keep W_h alone in shared memory.
    for mod, gates in CELLS.values():
        for cfg in (mod.launch_config(256, 5, 512, 512, torch.bfloat16),
                    mod.backward_launch_config(256, 5, 512, torch.float32)):
            assert "ring_rows" not in cfg
            assert cfg["smem_bytes"] == 32 * gates * cfg["k_padded"]


def test_grid_f32_plan_constants_are_rnn_cuh_s():
    """The Python plan's constants are csrc/rnn.cuh's (kGfSpan, kGfKSplit,
    kGfMaxBlock, kGfMaxStages, kGfSmem, kGfCounterStride), so the C side's
    check computes the same shared memory."""
    src = RNN_CUH.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kGfSpan") == cuda_gru.GRID_F32_SPAN
    assert const("kGfKSplit") == cuda_gru.GRID_F32_K_SPLIT
    assert const("kGfMaxBlock") == cuda_gru.GRID_F32_MAX_BLOCK
    assert const("kGfMaxStages") == cuda_gru.GRID_F32_MAX_STAGES
    assert const("kGfSmem") == cuda_gru.SMEM_LIMIT
    assert const("kGfCounterStride") == cuda_gru.GRID_F32_COUNTER_STRIDE
    assert const("kGridCounter") == cuda_gru.GRID_COUNTER
    assert const("kGridThreads") == cuda_gru.GRID_THREADS
