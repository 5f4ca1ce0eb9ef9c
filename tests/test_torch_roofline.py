"""The port's ``launch/roofline.py`` against the JAX package's: the same
collectives, as HLO lines for the reference's ``parse_collectives`` and
as the port's record entries (``core.comm.record()``), price to the same
wire bytes under the ring model; the summary and the roofline terms read
the H100's ``core.runtime.HW``; a group without a process group records
nothing."""

import pytest
import torch

from repro.launch import roofline as jroofline
from repro_torch.core import HW, Communicator
from repro_torch.core.comm import record
from repro_torch.launch import roofline

# (HLO kind, the port's kind, the HLO shape whose bytes the record holds)
KINDS = [("all-reduce", "all_reduce", "f32[1024]{0}", 4096),
         ("all-gather", "all_gather", "c64[8,256]{1,0}", 16384),
         ("reduce-scatter", "reduce_scatter", "f32[128]{0}", 512),
         ("all-to-all", "all_to_all", "bf16[8,64]{1,0}", 1024),
         ("collective-permute", "send_recv", "f32[300]{0}", 1200)]


@pytest.mark.parametrize("hlo,kind,shape,nbytes", KINDS,
                         ids=[k[1] for k in KINDS])
@pytest.mark.parametrize("n", [2, 8])
def test_ring_model_is_the_reference_s(hlo, kind, shape, nbytes, n):
    line = (f"  %x = {shape} {hlo}({shape} %p), "
            f"replica_groups=[1,{n}]<=[{n}]")
    want, = jroofline.parse_collectives(line)
    got, = roofline.collectives([{"kind": kind, "bytes": nbytes,
                                  "group": n}])
    assert (got["bytes"], got["group"]) == (want["bytes"], want["group"])
    assert got["wire_bytes"] == want["wire_bytes"]


def test_summary_and_terms_read_the_card():
    colls = roofline.collectives(
        [{"kind": "all_reduce", "bytes": 1000, "group": 4},
         {"kind": "all_gather", "bytes": 4000, "group": 4},
         {"kind": "broadcast", "bytes": 100, "group": 4},
         {"kind": "scatter", "bytes": 400, "group": 4},
         {"kind": "all_reduce", "bytes": 8, "group": 1}])
    s = roofline.collective_summary(colls)
    assert s["wire_bytes"] == 1500 + 3000 + 100 + 300
    assert s["by_kind"]["all_reduce"] == {"count": 1, "wire": 1500.0}
    t = roofline.roofline_terms({"flops": 67e12, "bytes": 3.35e9}, colls,
                                dtype="float32")
    assert HW["name"] == "NVIDIA H100 80GB HBM3"
    assert HW["power_limit_w"] == 700.0
    assert t["t_compute_s"] == pytest.approx(1.0)
    assert t["t_memory_s"] == pytest.approx(1e-3)
    assert t["t_collective_s"] == pytest.approx(4900 / HW["nvlink_bw"])
    assert t["dominant"] == "compute" and t["step_time_bound_s"] == \
        t["t_compute_s"]
    t16 = roofline.roofline_terms({"flops": 989e12}, [])
    assert t16["t_compute_s"] == pytest.approx(1.0)


def test_one_rank_records_nothing():
    comm = Communicator.single("cpu")
    with record() as outer:
        with record() as log:
            comm.allreduce(torch.ones(4))
            comm.vdot(torch.ones(3), torch.ones(3))
        assert log == []
    assert outer == []
