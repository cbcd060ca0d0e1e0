"""The trace reader: busy time is the union of the device records, the
window runs from the first record to the last, idle gaps are named by the
host operation under way, and host-range mirrors are no device work."""

from types import SimpleNamespace

import torch

from harness.trace import Trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, dev=CUDA, annotation=False):
    return SimpleNamespace(name=name, device_type=dev,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def test_busy_is_the_union_and_gaps_are_named():
    events = [_ev("k1", 0, 100), _ev("k2", 50, 150), _ev("k1", 400, 500),
              _ev("range", 0, 1000, annotation=True),
              _ev("aten::copy_", 140, 420, CPU),
              _ev("cudaLaunchKernel", 200, 210, CPU),
              _ev("step", 0, 1000, CPU)]
    t = Trace.read(SimpleNamespace(events=lambda: events))
    assert t.window_s == 1000 / 1e6
    assert t.busy_s == 250 / 1e6
    assert t.device_ops[0] == ["k1", 200 / 1e6]
    assert t.idle_gaps == [["during aten::copy_", 250 / 1e6]]
    assert t.kernel_time(("k1",)) == (2, 200 / 1e6)


def test_forward_log_counts_each_calls_launches():
    from competesmoe_tpu_torch.ops import matvec

    from harness.trace import ForwardLog, decoder_rows

    class Decoder(torch.nn.Module):
        def forward(self, input_ids, k5=0):
            matvec.quant_small_m_matmul_int4.launches += k5
            return input_ids

    m = Decoder()
    log = ForwardLog(m, decoder_rows)
    m(torch.zeros(32, 1), k5=128)
    m(torch.zeros(2, 300))
    got = log.between(0.0, float("inf"))
    assert got == [((32, 1), {"quant_small_m_matmul_int4": 128}),
                   ((2, 300), {})]
