"""The check catches the timed path broken underneath it: each fault a
cell of this benchmark can have is planted in the program's step, a run
is driven in-process on the CPU at a tiny size, and ``correct`` comes out
false.  A one-card cell has no exchange between chips to leave out."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import benchcopy  # noqa: E402

CELLS = ("tor10k.sweep8", "tor100k.web")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return benchcopy.tiny_copy(str(tmp_path_factory.mktemp("bench")))


def _unchanged_serial(orig):
    """The serial step returning its state unchanged: no tick advances
    anything, the flush reports nothing done."""
    from shadow_tpu_torch.ops.torcells_device import pack_flush_torch

    def step(t0, queued, ring, tokens, delivered, target, done_tick,
             node_sent, inject, inject_target, targets, idle, flow_node,
             flow_lat, flow_succ, seg_start, refill, capacity, last_flow,
             **kw):
        t_stop = int(torch.as_tensor(targets).reshape(-1)[-1])
        c, h = last_flow.shape[0], node_sent.shape[0]
        flush = pack_flush_torch(
            0, delivered[last_flow].sum(), t_stop,
            torch.zeros(c, dtype=torch.bool), done_tick[last_flow],
            torch.zeros(h, dtype=torch.int64))
        return (torch.tensor(t_stop), queued, ring, tokens, delivered,
                target, done_tick, node_sent, torch.tensor(0), flush)
    return step


def _unchanged_fleet(orig):
    from shadow_tpu_torch.ops.torcells_device import pack_flush_torch

    def step(t0, queued, ring, tokens, delivered, target, done_tick,
             node_sent, inject, inject_target, tvec, idle, flow_node,
             flow_lat, flow_succ, seg_start, refill, capacity, last_flow,
             **kw):
        w = queued.shape[0]
        flushes = []
        for i in range(w):
            c, h = last_flow.shape[1], node_sent.shape[1]
            flushes.append(pack_flush_torch(
                0, delivered[i][last_flow[i]].sum(), int(tvec[i][-1]),
                torch.zeros(c, dtype=torch.bool),
                done_tick[i][last_flow[i]],
                torch.zeros(h, dtype=torch.int64)))
        t_stop = torch.as_tensor([int(tvec[i][-1]) for i in range(w)])
        return (t_stop, queued, ring, tokens, delivered, target, done_tick,
                node_sent, torch.zeros(w, dtype=torch.int64),
                torch.stack(flushes))
    return step


def _half_left_out(orig):
    """Half of the batch left out: the injections of every second flow
    (serial) or of the upper half of the lanes (fleet) never enter."""
    def step(*args, **kw):
        args = list(args)
        inj, inj_t = args[8].clone(), args[9].clone()
        if inj.dim() == 1:
            inj[1::2] = 0
            inj_t[1::2] = 0
        else:
            inj[inj.shape[0] // 2:] = 0
            inj_t[inj_t.shape[0] // 2:] = 0
        args[8], args[9] = inj, inj_t
        return orig(*args, **kw)
    return step


def _answer_altered(orig):
    """An answer altered where it is produced: the first chain a flush
    reports done is reported one step later."""
    from shadow_tpu_torch.ops.torcells_device import FLUSH_HEADER

    def step(*args, **kw):
        out = orig(*args, **kw)
        flush = out[9].clone()
        rows = flush if flush.dim() == 2 else flush[None]
        c = args[18].shape[-1]
        for row in rows:
            if int(row[2]) > 0:
                row[FLUSH_HEADER + c] += 1
                break
        return (*out[:9], rows if flush.dim() == 2 else rows[0])
    return step


FAULTS = {"unchanged": (_unchanged_serial, _unchanged_fleet),
          "half_left_out": (_half_left_out, _half_left_out),
          "answer_altered": (_answer_altered, _answer_altered)}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(tiny, monkeypatch, cell, fault):
    from shadow_tpu_torch.ops import torcells_device as td
    serial, fleet = FAULTS[fault]
    name = ("torcells_step_span_flush_batched" if cell.endswith("sweep8")
            else "torcells_step_window_flush")
    make = fleet if cell.endswith("sweep8") else serial
    monkeypatch.setattr(td, name, make(getattr(td, name)))
    rc, result = benchcopy.run_inprocess(tiny, cell)
    assert rc == 0
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1


def test_sound_run_inprocess_is_correct(tiny):
    rc, result = benchcopy.run_inprocess(tiny, "tor100k.web")
    assert rc == 0 and result["correct"] is True, result
