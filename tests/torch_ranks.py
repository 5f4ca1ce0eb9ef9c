"""Rank bodies of the port's multi-rank tests.

Each runs in a rank process of its own, started by
``repro_torch.core.run_ranks`` as ``fn(env, *args)``, and returns numpy
arrays (which pickle back to the test).  The bodies that a 1-rank
communicator also runs in the test process take the communicator
(``*_on``).  This module imports no JAX: the ranks need none, and the
card tests import it too.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from repro_torch.core import Policy
from repro_torch.core.comm import ring_perm


def _np(x):
    return x.detach().cpu().numpy()


def digest(t) -> str:
    """The bits of a tensor, as a hash the ranks can compare."""
    return hashlib.sha256(_np(t).tobytes()).hexdigest()


# -- the core verbs -----------------------------------------------------------

def comm_verbs_on(comm, inp):
    """Every ported verb of ``comm`` on the inputs of
    ``test_torch_core_comm``; one dict of results per rank."""
    r, n = comm.rank, comm.size
    out = {}
    segs = {"nat": comm.container(inp["nat"]),
            "blk": comm.container(inp["blk"], policy=Policy.BLOCK, block=2),
            "cln": comm.container(inp["cln"], policy=Policy.CLONE)}
    for k, s in segs.items():
        out[f"{k}_local"] = _np(s.data)
        out[f"{k}_gather"] = _np(comm.gather(s))
        out[f"{k}_segments"] = s.segments()
        out[f"{k}_seg_len"] = [s.seg_len(i) for i in range(n)]
        out[f"{k}_global_shape"] = s.global_shape
    nat = segs["nat"]
    out["allreduce"] = _np(comm.allreduce(nat).data)
    out["reduce_max"] = _np(comm.reduce(nat, "max"))
    out["allgather"] = _np(comm.allgather(segs["blk"]).data)
    out["allgather_local"] = _np(comm.allgather(nat.data, dim=0))
    stack = comm.container(inp["stack"])
    out["window"] = _np(comm.allreduce_window(stack, ((2, 6), (2, 6))).data)
    out["bcast"] = _np(comm.bcast(inp["cln"] + r, src=0).data)
    sc = comm.scatter(inp["nat"] if r == 0 else None)
    out["scatter"] = (_np(sc.data), sc.global_shape, sc.orig_len)
    u = {"rho": comm.container(inp["rho"], policy=Policy.CLONE),
         "chat": comm.container(inp["chat"])}
    v = {"rho": comm.container(inp["rho2"], policy=Policy.CLONE),
         "chat": comm.container(inp["chat2"])}
    out["vdot_eager"] = complex(comm.vdot(u, v))
    out["vdot_local"] = complex(comm.vdot(
        {k: s.data for k, s in u.items()}, {k: s.data for k, s in v.items()},
        policies={"rho": Policy.CLONE, "chat": Policy.NATURAL}))
    out["shift"] = _np(comm.shift(nat, 1).data)
    out["shift_open"] = _np(comm.shift(nat, -1, wrap=False).data)
    out["send_recv"] = _np(comm.send_recv(
        nat, [(i, n - 1 - i) for i in range(n)]).data)
    out["send_recv_partial"] = _np(comm.send_recv(nat, [(0, n - 1)]).data)
    out["ring_perm"] = ring_perm(n, 1)
    # the fused channel sum's verb, both schedules, on this rank's plane
    x = torch.from_numpy(inp["ovl"][r % len(inp["ovl"])])
    extras = (torch.tensor(inp["e_re"][r % len(inp["e_re"])]),
              torch.tensor(inp["e_c"][r % len(inp["e_c"])]))
    win = ((2, 6), (2, 6))
    red, ex, c = comm.allreduce_overlap(x, win, extras=extras,
                                        compute=lambda: torch.ones(2))
    out["ovl_psum"] = (_np(red), _np(ex[0]), _np(ex[1]), _np(c))
    mask = torch.from_numpy(inp["mask"])
    red, ex, _ = comm.allreduce_overlap(x, win, extras=extras,
                                        mask=mask[2:6, 2:6].contiguous())
    out["ovl_masked"] = (_np(red), _np(ex[0]), _np(ex[1]))
    red, _, _ = comm.allreduce_overlap(x, None, mask=mask)
    out["ovl_masked_full"] = _np(red)
    comm.barrier()
    out["fence"] = _np(comm.barrier_fence(torch.ones(2)))
    return out


def comm_verbs(env, inp):
    return comm_verbs_on(env.world, inp)


def raise_on_rank_1(env):
    if env.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return env.rank


def masked_psum_crop_rank(env, partials, mask):
    """``masked_psum_crop`` of this rank's partial plane."""
    from repro_torch.kernels.masked_allreduce import masked_psum_crop
    comm = env.world
    x = torch.from_numpy(partials[comm.rank])
    return _np(masked_psum_crop(x, torch.from_numpy(mask), comm))


# -- the segmented BLAS -------------------------------------------------------

def blas_on(comm, inp):
    """Every segmented ``lib.blas`` form on CG-state containers (``rho``
    CLONE, ``chat`` NATURAL); the vector results come back gathered."""
    from repro_torch.kernels import registry
    from repro_torch.lib import blas

    def tree(prefix):
        return {"rho": comm.container(inp[prefix + "rho"],
                                      policy=Policy.CLONE),
                "chat": comm.container(inp[prefix + "chat"])}

    def gathered(t):
        return {k: _np(s.gather()) for k, s in t.items()}

    x, y, z, w = tree("x_"), tree("y_"), tree("z_"), tree("w_")
    a, b = inp["a"], torch.tensor(inp["b"])
    out = {"axpy": gathered(blas.axpy(a, x, y)),
           "dot": _np(blas.dot(x, y)), "norm2": _np(blas.norm2(x)),
           "dot_allreduce": _np(blas.dot_allreduce(x["chat"], y["chat"])),
           "dot_allreduce_clone": _np(blas.dot_allreduce(x["rho"],
                                                         y["rho"]))}
    wv, d = blas.axpy_dot(a, x, y, z)
    out["axpy_dot"] = (gathered(wv), _np(d))
    wv, nrm = blas.axpy_norm2(a, x, y)
    out["axpy_norm2"] = (gathered(wv), _np(nrm))
    before = registry.get("xpby_dot").launches
    wv, d = blas.xpby_dot(x, y, b)
    out["xpby_dot"] = (gathered(wv), _np(d))
    out["xpby_dot_launches"] = registry.get("xpby_dot").launches - before
    x2, r2, rs = blas.cg_update(a, x, y, z, w)
    out["cg_update"] = (gathered(x2), gathered(r2), _np(rs))
    out["single_leaf"] = _np(blas.xpby_dot(x["chat"], y["chat"], b)[1])
    return out


def blas_rank(env, inp):
    return blas_on(env.world, inp)


# -- the distributed NLINV frame ----------------------------------------------

# the channel-sum schedules of a frame case: (overlap, hierarchical, the
# (2, 2) ("pod", "data") group or the 1-axis one)
SCHEDULES = {"psum": ("psum", False, False), "p2p": ("p2p", False, False),
             "hier": ("psum", True, False), "hier22": ("psum", True, True)}


def _solve(comm, d, newton, cg, mode, fused=True, fov_scale=1.0,
           schedule="psum"):
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor, pad_channels
    overlap, hierarchical, _ = SCHEDULES[schedule]
    rec = Reconstructor(comm, newton=newton, cg_iters=cg, channel_sum=mode,
                        fused=fused, overlap=overlap,
                        hierarchical=hierarchical)
    g = d["grid"]
    y = pad_channels(d["y"][0], comm.size)
    u0 = rec.init_carry(y.shape[0], g)
    u, img = rec(rec.put_frame(y), rec.put_const(d["masks"][0]),
                 rec.put_const(fov_scale * d["fov"]),
                 rec.put_const(sobolev_weight(g)),
                 u0, {k: v.clone() for k, v in u0.items()})
    chat = comm.container(np.zeros((y.shape[0], g, g), np.complex64))
    return {"img": _np(img), "rho": digest(u["rho"]),
            "chat": _np(chat.with_data(u["chat"]).gather()),
            "chat_local": _np(u["chat"]), "log": list(rec.cg_log)}


def nlinv_on(comm, d, cases, mesh=None):
    """One frame per ``(newton, cg, channel_sum, fused[, fov_scale[,
    schedule]])`` case on ``comm``'s ranks (the ``"hier22"`` schedule's
    on ``mesh``, the (2, 2) group); each rank's image, its ``rho``'s
    bits, the gathered ``chat`` and the CG log."""
    def on(case):
        two_axes = len(case) > 5 and SCHEDULES[case[5]][2]
        return mesh if two_axes else comm
    return {case: _solve(on(case), d, *case) for case in cases}


def nlinv_rank(env, d, cases):
    """``nlinv_on`` over every rank, the (2, 2) ("pod", "data") group made
    on every rank before the first frame."""
    mesh = env.group((2, 2), ("pod", "data")) if env.world_size == 4 \
        else None
    return nlinv_on(env.world, d, cases, mesh)


def nlinv_global_and_stream_rank(env, d, newton, cg, movie, carry):
    """``make_dist_reconstruct`` on global inputs (the JAX call form),
    ``FrameStream`` over ``movie`` on every rank, and a resume of its
    last frame from ``carry``, a global numpy carry after frame 0."""
    from repro_torch import convert
    from repro_torch.nlinv.operators import sobolev_weight, uinit
    from repro_torch.nlinv.recon import (Reconstructor, make_dist_reconstruct,
                                         pad_channels)
    from repro_torch.nlinv.stream import FrameStream
    comm = env.world
    fn = make_dist_reconstruct(comm, newton=newton, cg_iters=cg,
                               channel_sum="crop")
    y = pad_channels(d["y"][0], comm.size)
    u0 = {k: _np(v) for k, v in uinit(y.shape[0], d["grid"],
                                      device="cpu").items()}
    u, img = fn(y, d["masks"][0], d["fov"], sobolev_weight(d["grid"]), u0,
                u0)
    rec = Reconstructor(comm, newton=newton, cg_iters=cg)
    stream = FrameStream(rec)
    frames, rep = stream.run(movie["y"], movie["masks"], movie["fov"])
    log = list(rec.cg_log)
    shapes = {k: tuple(v.shape) for k, v in stream.last_carry["u"].items()}
    from repro_torch.nlinv.recon import U_POLICIES
    seg = convert.segmented_from_numpy(carry, comm, U_POLICIES)
    carry_back = convert.segmented_to_numpy(seg)
    resumed, _ = FrameStream(rec).run(
        movie["y"][1:], movie["masks"][1:], movie["fov"],
        carry={part: {k: s.data for k, s in leaves.items()}
               for part, leaves in seg.items()})
    return {"img": _np(img.data), "rho": _np(u["rho"].data),
            "chat": _np(u["chat"].gather()), "movie": _np(frames),
            "devices": rep.summary()["devices"], "log": log,
            "carry": shapes, "resumed": _np(resumed),
            "carry_back": carry_back}


# -- the transfer schedules ---------------------------------------------------

def _meta(seg):
    return (seg.policy.value, seg.dim, seg.block, seg.orig_len, seg.halo,
            tuple(seg.global_shape))


def schedules_on(comm, inp):
    """``tests/test_transfer_schedules.py``'s parity body on ``comm``:
    both broadcast schedules, every copy route beside the ``rebuild``
    fallback, both reduce schedules, ``reduce_scatter``, the GEMMs and
    ``fft2_batched``, each forced through the module flags."""
    from repro_torch.core import comm as C
    from repro_torch.core.segmented import segment
    from repro_torch.lib import blas
    from repro_torch.lib import fft as F
    from repro_torch.lib.plan import default_cache
    out = {}
    try:
        for sched in ("device_put", "scatter_allgather"):
            C.BCAST_SCHEDULE = sched
            s = comm.bcast(inp["x"] if comm.rank == 0 else 0 * inp["x"])
            out[f"bcast_{sched}"] = (s.policy.value, _np(s.gather()))
    finally:
        C.BCAST_SCHEDULE = None

    def parity(name, src, **kw):
        route = C.copy_route(src, **kw)
        got = comm.copy(src, **kw)
        pol = kw.get("policy") or src.policy
        ref = segment(src.gather(), comm, policy=pol,
                      dim=kw.get("dim", src.dim), block=kw.get("block"),
                      halo=kw.get("halo") or 0)
        out[f"copy_{name}"] = {
            "route": route, "gather": _np(got.gather()), "meta": _meta(got),
            "local": _np(got.data), "ref_gather": _np(ref.gather()),
            "ref_meta": _meta(ref), "ref_local": _np(ref.data)}
        return got

    nat = comm.container(inp["xs"])
    cl = parity("replicate", nat, policy=Policy.CLONE)
    parity("clone_split", cl, policy=Policy.NATURAL)
    parity("clone_split_block", cl, policy=Policy.BLOCK, block=2)
    parity("alltoall", nat, dim=1)
    parity("block_pack", nat, policy=Policy.BLOCK, block=2)
    blk = comm.container(inp["xs"], policy=Policy.BLOCK, block=2)
    parity("block_unpack", blk, policy=Policy.NATURAL)
    natp = comm.container(inp["xp"])
    clp = parity("replicate_padded", natp, policy=Policy.CLONE)
    parity("clone_split_padded", clp, policy=Policy.NATURAL)
    parity("alltoall_padded", natp, dim=1)
    parity("unaligned", comm.container(inp["xu"]), policy=Policy.BLOCK,
           block=2)
    ov = comm.container(inp["xo"], policy=Policy.OVERLAP2D, halo=1)
    ov2 = comm.copy(ov, halo=3)
    out["halo_only"] = (C.copy_route(ov, halo=3), ov2.data is ov.data,
                        ov2.halo, C.copy_route(ov),
                        comm.copy(ov).data is ov.data,
                        C.copy_route(cl), comm.copy(cl).data is cl.data)
    sr = comm.container(inp["xr"])
    try:
        for sched in ("psum", "rs_ag"):
            C.REDUCE_SCHEDULE = sched
            out[f"reduce_{sched}"] = (C.plan_reduce(sr).meta["schedule"],
                                      _np(comm.reduce(sr)),
                                      _np(comm.allreduce(sr).gather()))
            sa, sb = comm.container(inp["A"], dim=1), \
                comm.container(inp["B"])
            out[f"gemm_{sched}"] = (blas.gemm_ksplit_schedule(sa, sb),
                                    _np(blas.gemm_ksplit(sa, sb).data))
    finally:
        C.REDUCE_SCHEDULE = None
    for op in ("sum", "max", "min"):
        rs = comm.reduce_scatter(sr, op)
        out[f"reduce_scatter_{op}"] = (rs.policy.value, _np(rs.gather()),
                                       C.plan_reduce_scatter(sr, op)
                                       .meta["schedule"])
    ga, gb = comm.container(inp["Ga"]), comm.container(inp["Gb"])
    out["gemm_batched"] = _np(blas.gemm_batched(ga, gb).gather())
    for name, seg in (("fft_dim0", comm.container(inp["xf"])),
                      ("fft_dim1", comm.container(inp["xf"], dim=1)),
                      ("fft_dim2", comm.container(inp["xf"], dim=2)),
                      ("fft_overlap2d", comm.container(
                          inp["xf"], dim=1, policy=Policy.OVERLAP2D,
                          halo=1)),
                      ("fft_fallback", comm.container(inp["xv"], dim=1))):
        plan = F.plan_fft2_batched(seg)
        res = plan(seg)
        out[name] = (plan.meta["schedule"], _np(res.gather()), _meta(res)
                     == _meta(seg))
    before = default_cache().snapshot()
    F.plan_fft2_batched(comm.container(inp["xf"], dim=1))
    out["fft_steady_builds"] = default_cache().delta(before)["builds"]
    return out


def schedules_rank(env, inp):
    """``schedules_on`` on the first 2 ranks and on all 4, each rank's
    results by group size."""
    two = env.subgroup(2)
    res = {2: schedules_on(two, inp)} if two is not None else {}
    res[env.world_size] = schedules_on(env.world, inp)
    return res


# -- the ring, the hierarchy, the halo, the launchers, the survivor -----------

def verbs_rank(env, inp):
    """The p2p ring, the hierarchical sum on the (2, 2) group, the
    OVERLAP2D halo exchange, ``invoke``/``invoke_all`` and ``survivor``
    on 4 ranks; numpy arrays and digests back."""
    from repro_torch.core import (PassThrough, dev_rank, hierarchical_psum,
                                  ring_allreduce)
    from repro_torch.core import comm as C
    comm = env.world
    r = comm.rank
    out = {}
    x = torch.from_numpy(inp["ring"][r])
    events = []
    send_recv_many = C._send_recv_many

    def counted(*a, **k):
        events.append("round")
        return send_recv_many(*a, **k)

    C._send_recv_many = counted
    try:
        for op in ("sum", "max"):
            for chunks in (1, 2, 3):
                events.clear()
                red, c = ring_allreduce(
                    x, op, chunks=chunks, comm=comm,
                    compute=lambda: events.append("compute") or 7)
                out[f"ring_{op}_{chunks}"] = (_np(red), digest(red), c,
                                              list(events))
        red = ring_allreduce((x, torch.tensor(float(r))), comm=comm)
        out["ring_tuple"] = (_np(red[0]), float(red[1]))
    finally:
        C._send_recv_many = send_recv_many
    stack = comm.container(inp["stack"])
    win = ((1, 5), (1, 5))
    out["p2p_window"] = (_np(comm.allreduce_window(stack, win).data),
                         _np(comm.allreduce_window(stack, win,
                                                   p2p=True).data))
    out["p2p_allreduce"] = (_np(stack.allreduce(p2p=True).data),
                            _np(stack.allreduce("max", p2p=True).data))
    # the fused channel sum's verb under each schedule, with a mask
    plane = torch.from_numpy(inp["ovl"][r])
    extras = (torch.tensor(inp["e_re"][r]), torch.tensor(inp["e_c"][r]))
    mask = torch.from_numpy(inp["mask"])[1:5, 1:5].contiguous()
    for name, kw in (("gathered", {}), ("p2p", {"p2p": True}),
                     ("p2p3", {"p2p": True, "chunks": 3}),
                     ("hier1", {"hierarchical": True})):
        red, ex, _ = comm.allreduce_overlap(plane, win, extras=extras,
                                            mask=mask, **kw)
        out[f"ovl_{name}"] = (_np(red), _np(ex[0]), _np(ex[1]))
    red, ex, c = comm.allreduce_overlap(plane, win, extras=extras, p2p=True,
                                        compute=lambda: torch.ones(2))
    out["ovl_p2p_nomask"] = (_np(red), _np(ex[0]), _np(ex[1]), _np(c))
    mesh = env.group((2, 2), ("pod", "data"))
    out["mesh"] = (mesh.group.coords, mesh.group.ici_axes,
                   mesh.group.dcn_axes, mesh.size,
                   mesh.group.sub("data").rank, mesh.group.sub("pod").rank)
    for name in ("hier_tiled", "hier_fallback"):
        s = mesh.container(inp[name])
        out[name] = (_np(s.allreduce(hierarchical=True).data),
                     C._hier_axes(s.data.sum(0), mesh.group) is not None)
    local = torch.from_numpy(inp["hier_tiled"][r])
    out["hier_local"] = _np(hierarchical_psum(local, mesh.group))
    red, ex, _ = mesh.allreduce_overlap(plane, win, extras=extras, mask=mask,
                                        hierarchical=True)
    out["ovl_hier22"] = (_np(red), _np(ex[0]), _np(ex[1]))
    # OVERLAP2D
    so = comm.container(inp["halo_x"], policy=Policy.OVERLAP2D, halo=2)
    out["halo_round_trip"] = (_np(so.gather()), [t[0] for t in
                                                 so.segments()],
                              _np(comm.scatter(inp["halo_x"], policy=Policy
                                               .OVERLAP2D, halo=1).gather()))
    for h in (0, 1, 2):
        s = comm.container(inp["halo_x"], policy=Policy.OVERLAP2D, halo=h)

        def stencil(e, h=h):
            rows = e.shape[0] - 2 * h
            return sum(e[k:k + rows] for k in range(2 * h + 1))

        out[f"halo_{h}"] = _np(s.halo_exchange(stencil).gather())
    ext = so.halo_exchange()
    out["halo_ext"] = (ext.policy.value, tuple(ext.global_shape),
                       _np(ext.data))
    # the launchers
    seg = comm.container(inp["halo_x"])
    one = comm.invoke(lambda xl: xl * 10, seg, rank=2)
    allr = comm.invoke_all(lambda xl, full, w: xl + full.sum() + w, seg,
                           PassThrough(seg), inp["w"])
    out["invoke"] = (_np(one.gather()), _np(allr.gather()),
                     dev_rank(comm), _np(seg.invoke(lambda xl: -xl).data))
    # the survivor of a lost rank 2
    surv = env.survivor(comm, lost=(2,))
    out["survivor"] = None if surv is None else (
        surv.size, surv.rank, float(surv.allreduce(torch.tensor(r + 1.0))))
    return out


# -- eight ranks ----------------------------------------------------------------

def crop_wire_bytes_on(comm, d, newton, cg):
    """Frame 0 of ``d`` under each channel sum on ``comm``, its
    collectives recorded (``core.comm.record``): ``{mode: records}``."""
    from repro_torch.core.comm import record
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor
    out = {}
    for mode in ("full", "crop"):
        rec = Reconstructor(comm, newton=newton, cg_iters=cg,
                            channel_sum=mode)
        g = d["grid"]
        u0 = rec.init_carry(d["ncoils"], g)
        args = (rec.put_frame(d["y"][0]), rec.put_const(d["masks"][0]),
                rec.put_const(d["fov"]), rec.put_const(sobolev_weight(g)),
                u0, {k: v.clone() for k, v in u0.items()})
        with record() as log:
            rec(*args)
        out[mode] = list(log)
    return out


def core_eight_on(comm, inp):
    """``tests/test_core_multidevice.py``'s containers, invoke, BLAS and
    FFT through the verbs of ``comm``; every result gathered to numpy."""
    from repro_torch.core import PassThrough
    from repro_torch.lib import blas, fft
    out = {}
    x = comm.container(inp["x"])
    out["natural"] = _np(x.gather())
    out["natural_len"] = x.data.shape[0]
    out["padded"] = _np(comm.container(inp["x2"]).gather())
    out["block"] = _np(comm.container(inp["x2"], policy=Policy.BLOCK,
                                      block=2).gather())
    out["clone"] = _np(comm.bcast(inp["x"]).data)
    sm = comm.container(inp["m"])
    out["reduce"] = _np(comm.reduce(sm))
    out["all_reduce"] = _np(comm.allreduce(sm).gather())
    out["all_reduce_max"] = _np(comm.allreduce(sm, "max").gather())
    out["copy_clone"] = _np(comm.copy(x, policy=Policy.CLONE).gather())
    st = comm.alltoall(comm.container(inp["xt"]), 1)
    out["all_to_all"] = (_np(st.gather()), st.dim)
    out["reduce_scatter"] = _np(comm.reduce_scatter(sm).gather())
    so = comm.container(inp["xo"], policy=Policy.OVERLAP2D, halo=1)
    out["overlap_identity"] = _np(so.halo_exchange(lambda e: e[1:-1])
                                  .gather())
    out["overlap_stencil"] = _np(so.halo_exchange(
        lambda e: e[:-2] + e[1:-1] + e[2:]).gather())
    sx, sy = comm.container(inp["bx"]), comm.container(inp["by"])
    out["axpy"] = _np(blas.axpy(2.0, sx, sy).gather())
    out["dot"] = _np(blas.dot(comm.container(inp["xc"]),
                              comm.container(inp["yc"])))
    out["gemm_batched"] = _np(blas.gemm_batched(
        comm.container(inp["a"]), comm.container(inp["b"])).gather())
    out["gemm_ksplit"] = _np(blas.gemm_ksplit(
        comm.container(inp["A"], dim=1),
        comm.container(inp["B"], dim=0)).gather())
    sf = comm.container(inp["xf"])
    f = fft.fft2_batched(sf, centered=True)
    out["fft2_batched"] = _np(f.gather())
    out["fft2_inverse"] = _np(fft.fft2_batched(f, inverse=True,
                                               centered=True).gather())
    out["invoke_all"] = _np(comm.invoke_all(lambda a, b: a * 2.0 + b, sx,
                                            sy).gather())
    out["pass_through"] = _np(comm.invoke_all(
        lambda a, full: a + full.sum(), sx, PassThrough(sx)).gather())
    out["invoke_rank"] = _np(comm.invoke(lambda a: a + 1.0, sx,
                                         rank=3).gather())
    comm.barrier_fence(sx.data)
    return out


def hierarchical_on(mesh, m):
    """The flat and the hierarchical all-reduce of ``m`` segmented over a
    ``("pod", "data")`` mesh, gathered."""
    sm = mesh.container(m)
    return (_np(mesh.allreduce(sm).gather()),
            _np(mesh.allreduce(sm, hierarchical=True).gather()))


def eight_rank(env, d, newton, cg, inp):
    """One rank of ``test_torch_core_eight``: the crop channel sum's wire
    bytes, the containers, invoke, BLAS and FFT on the world, and the
    hierarchical all-reduce on a ``(2, 4)`` ``("pod", "data")`` mesh."""
    comm = env.world
    mesh = env.group((2, 4), ("pod", "data"))
    return {"bytes": crop_wire_bytes_on(comm, d, newton, cg),
            "core": core_eight_on(comm, inp),
            "hier": hierarchical_on(mesh, inp["hm"]),
            "axes": (mesh.group.ici_axes, mesh.group.dcn_axes)}


# -- coil-segmented gridding --------------------------------------------------

def gridding_rank(env, traj, grid, k, y, fov):
    """The radial plan's ``degrid``, ``grid`` and ``adjoint_recon`` on
    coil-segmented containers over every rank, gathered."""
    from repro_torch.lib.gridding import plan_gridding
    comm = env.world
    plan = plan_gridding(traj, grid, device=comm.device)
    kc, yc = comm.container(k), comm.container(y)
    samples = plan.degrid(kc)
    back = plan.grid(yc, density_comp=True)
    return {"degrid": _np(samples.gather()), "grid": _np(back.gather()),
            "recon": _np(plan.adjoint_recon(yc, fov)),
            "types": (type(samples).__name__, samples.policy.value,
                      type(back).__name__)}


# -- fault tolerance: the service under injected faults -----------------------

def _results(session):
    """A session's results as numpy, a ``Rejected`` frame as ``None``."""
    from repro_torch.serve import Rejected
    return [None if isinstance(r, Rejected) else _np(r)
            for r in session.results]


def serve_chaos_on(comm, datas, specs, *, seed=1234, retry=None,
                   newton=2, cg=6, buckets=(1, 2, 4)):
    """The reference's ``SERVE_CHAOS`` run: every client's frames through
    ``NlinvStreamWorkload`` on ``comm`` under ``FaultInjector(specs,
    seed)``, ticking until each frame is served.  Returns ``(sched,
    sessions, injector)``."""
    from repro_torch.ft import FaultInjector
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import (NlinvStreamWorkload, ServeConfig,
                                   StreamScheduler)
    rec = Reconstructor(comm, newton=newton, cg_iters=cg,
                        channel_sum="crop")
    sched = StreamScheduler(NlinvStreamWorkload(rec, retry=retry),
                            ServeConfig(buckets=buckets))
    ncoils = datas[0]["y"].shape[1]
    ss = [sched.open(client=f"c{k}", grid=d["grid"], ncoils=ncoils,
                     fov=d["fov"]) for k, d in enumerate(datas)]
    inj = FaultInjector(specs, seed=seed)
    with inj:
        for f in range(datas[0]["y"].shape[0]):
            for k, d in enumerate(datas):
                sched.submit(ss[k], (d["y"][f], d["masks"][f]))
            while sched.tick() == 0 and any(
                    s.pending for s in sched.sessions.values()):
                pass
    return sched, ss, inj


# the reference's SERVE_CHAOS cases: (name, specs, seed, retry policy)
CHAOS_CASES = (
    ("clean", (), 1234, None),
    ("retry", ({"site": "task", "kind": "transient", "match": "solve",
                "at": (1,), "max_fires": 1},), 1234, (2, 0.0)),
    ("corrupt", ({"site": "step", "kind": "corrupt", "at": (1,),
                  "pick": 1, "max_fires": 1},), 1234, None),
    ("step", ({"site": "step", "kind": "transient", "at": (1,),
               "max_fires": 1},), 1234, None),
    ("straggle_a", ({"site": "task", "kind": "straggle", "match": "solve",
                     "prob": 0.4, "delay_ms": 0.0},), 7, None),
    ("straggle_b", ({"site": "task", "kind": "straggle", "match": "solve",
                     "prob": 0.4, "delay_ms": 0.0},), 7, None),
)


def serve_chaos_cases(comm, datas):
    """Every ``CHAOS_CASES`` run on ``comm``: each client's results, the
    fired log, the scheduler's and the workload's fault counters."""
    from repro_torch.ft import FaultSpec, RestartPolicy
    out = {}
    for name, specs, seed, retry in CHAOS_CASES:
        policy = None if retry is None else RestartPolicy(
            max_restarts=retry[0], backoff_s=retry[1])
        sched, ss, inj = serve_chaos_on(
            comm, datas, [FaultSpec(**s) for s in specs], seed=seed,
            retry=policy)
        rep = sched.report()["aggregate"]["ft"]
        out[name] = {"results": [_results(s) for s in ss],
                     "fired": list(inj.fired),
                     "poisoned": [s.poisoned for s in ss],
                     "step_faults": sched.step_faults,
                     "ft": {k: rep[k] for k in ("step_faults",
                                                "quarantined",
                                                "retried_tasks",
                                                "remeshes")}}
    return out


def pipeline_drain_on(comm, newton=2, cg=4):
    """The reference's ``PIPELINE_DRAIN``: ``FramePipeline`` over a random
    5-frame movie clean, with a transient solve absorbed by the retry,
    and with one dropped (``drop_failed``)."""
    from repro_torch.ft import FaultInjector, FaultSpec, RestartPolicy
    from repro_torch.nlinv.recon import Reconstructor, pad_channels
    from repro_torch.nlinv.stream import FramePipeline
    rec = Reconstructor(comm, newton=newton, cg_iters=cg)
    rng = np.random.default_rng(0)
    F, J, g = 5, 2, 16
    y = rng.normal(size=(F, J, g, g)) + 1j * rng.normal(size=(F, J, g, g))
    y = pad_channels(y.astype(np.complex64), comm.size, axis=1)
    masks = (rng.random(size=(F, g, g)) < 0.4).astype(np.float32)
    fov = np.ones((g, g), np.float32)
    ref, _ = FramePipeline(rec, inflight=2).run(y, masks, fov)
    with FaultInjector([FaultSpec(site="task", kind="transient",
                                  match="solve", at=(1,), max_fires=1)],
                       seed=1):
        pipe = FramePipeline(rec, inflight=2, retry=RestartPolicy(
            max_restarts=2, backoff_s=0.0))
        retried, rep_r = pipe.run(y, masks, fov)
    with FaultInjector([FaultSpec(site="task", kind="transient",
                                  match="solve", at=(2,), max_fires=1)],
                       seed=1):
        pipe = FramePipeline(rec, inflight=2, drop_failed=True)
        dropped, rep_d = pipe.run(y, masks, fov)
    return {"ref": _np(ref), "retried": _np(retried),
            "retried_summary": rep_r.summary(), "dropped": _np(dropped),
            "dropped_summary": rep_d.summary()}


def batched_frame_on(comm, datas, newton=2, cg=6, schedule="psum"):
    """Frame 0 of every client through one batched frame on ``comm``
    (``schedule`` as ``SCHEDULES`` names it), and through the unbatched
    frame a client at a time: each row's image and ``rho`` bits, the CG
    logs, and the ``masked_sum`` calls the batched frame made (counted at
    the channel sum's call site)."""
    from repro_torch.core import comm as core_comm
    from repro_torch.core.plan import PlanCache
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor, pad_channels
    from repro_torch.serve import stack_carries, unstack_carry
    overlap, hierarchical, _ = SCHEDULES[schedule]
    rec = Reconstructor(comm, newton=newton, cg_iters=cg,
                        channel_sum="crop", overlap=overlap,
                        hierarchical=hierarchical)
    rec.plan_cache = PlanCache()
    g = datas[0]["grid"]
    ys = [pad_channels(d["y"][0], comm.size) for d in datas]
    y = torch.stack([rec.put_frame(v) for v in ys])
    m = torch.stack([rec.put_const(d["masks"][0]) for d in datas])
    fov = rec.put_const(datas[0]["fov"])
    w = rec.put_const(sobolev_weight(g))
    u0 = stack_carries([rec.init_carry(ys[0].shape[0], g) for _ in datas])
    calls = []
    real = core_comm.masked_sum

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    core_comm.masked_sum = counted
    try:
        u, img = rec.fn_batched(len(datas))(
            y, m, fov, w, u0, {k: v.clone() for k, v in u0.items()})
    finally:
        core_comm.masked_sum = real
    log = list(rec.cg_log)
    own = []
    for b in range(len(datas)):
        row = unstack_carry(u0, b)
        rec.cg_log.clear()
        ub, ib = rec.fn(y[b], m[b], fov, w, row,
                        {k: v.clone() for k, v in row.items()})
        own.append({"img": _np(ib), "rho": digest(ub["rho"]),
                    "chat": digest(ub["chat"]), "log": list(rec.cg_log)})
    return {"img": _np(img), "rho": [digest(u["rho"][b])
                                     for b in range(len(datas))],
            "chat": [digest(u["chat"][b]) for b in range(len(datas))],
            "log": log, "masked_sum_calls": len(calls), "own": own}


def unfused_batched_on(comm, datas, width, newton, cg, nan_row=None):
    """Frame 0 of the first ``width`` clients through one unfused batched
    frame on ``comm`` (``nan_row``: that client's samples all NaN), and
    through the unbatched unfused frame a client at a time: the batched
    image, ``rho`` and this rank's ``chat``, and each row's own frame."""
    from repro_torch.core.plan import PlanCache
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor, pad_channels
    from repro_torch.serve import stack_carries, unstack_carry
    rec = Reconstructor(comm, newton=newton, cg_iters=cg,
                        channel_sum="crop", fused=False)
    rec.plan_cache = PlanCache()
    datas = datas[:width]
    g = datas[0]["grid"]
    ys = [pad_channels(d["y"][0], comm.size) for d in datas]
    if nan_row is not None:
        ys[nan_row] = np.full_like(ys[nan_row], np.nan)
    y = torch.stack([rec.put_frame(v) for v in ys])
    m = torch.stack([rec.put_const(d["masks"][0]) for d in datas])
    fov = rec.put_const(datas[0]["fov"])
    w = rec.put_const(sobolev_weight(g))
    u0 = stack_carries([rec.init_carry(ys[0].shape[0], g) for _ in datas])
    u, img = rec.fn_batched(width)(y, m, fov, w, u0,
                                   {k: v.clone() for k, v in u0.items()})
    own = []
    for b in range(width):
        row = unstack_carry(u0, b)
        ub, ib = rec.fn(y[b], m[b], fov, w, row,
                        {k: v.clone() for k, v in row.items()})
        own.append({"img": _np(ib), "rho": _np(ub["rho"])})
    return {"img": _np(img), "rho": _np(u["rho"]), "chat": _np(u["chat"]),
            "bits": digest(img) + digest(u["rho"]), "own": own}


def unfused_batched_rank(env, datas, cases):
    """``unfused_batched_on`` on the world for each ``(width, newton,
    cg)`` case."""
    return {c: unfused_batched_on(env.world, datas, *c) for c in cases}


def elastic_remesh_on(env, datas, newton=2, cg=6, lost=(2, 3)):
    """The reference's ``ELASTIC_REMESH`` on the world's ranks: an
    uninterrupted run, then a run in which ``device_loss`` hits the third
    solve; every rank remeshes (the ranks ``lost`` retire, their workload
    refusing a later step), the survivors resubmit the frame and tick
    on."""
    from repro_torch.ft import DeviceLossFault, FaultInjector, FaultSpec
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.serve import (NlinvStreamWorkload, ServeConfig,
                                   StreamScheduler)
    comm = env.world
    ncoils = datas[0]["y"].shape[1]
    F = datas[0]["y"].shape[0]

    def open_all(sched):
        return [sched.open(client=f"c{k}", grid=d["grid"], ncoils=ncoils,
                           fov=d["fov"]) for k, d in enumerate(datas)]

    def feed(sched, ss, f):
        for k, d in enumerate(datas):
            sched.submit(ss[k], (d["y"][f], d["masks"][f]))

    def make():
        rec = Reconstructor(comm, newton=newton, cg_iters=cg,
                            channel_sum="crop")
        wl = NlinvStreamWorkload(rec)
        return wl, StreamScheduler(wl, ServeConfig(buckets=(1, 2)))

    _, sched = make()
    ref = open_all(sched)
    for f in range(F):
        feed(sched, ref, f)
        sched.tick()
    wl, sched = make()
    ss = open_all(sched)
    inj = FaultInjector([FaultSpec(site="task", kind="device_loss",
                                   match="solve", at=(2,), device=lost[0])],
                        seed=0)
    lost_at = survivor_size = None
    tick_ms = {"before": [], "after": []}
    with inj:
        for f in range(F):
            feed(sched, ss, f)
            try:
                sched.tick()
                tick_ms["before" if lost_at is None else "after"].append(
                    sched.tick_ms[-1])
            except DeviceLossFault as e:
                lost_at = f
                survivor = env.survivor(wl.rec.comm,
                                        lost=(e.device,) + lost[1:])
                wl.remesh(survivor, sessions=ss)
                if survivor is None:
                    break
                survivor_size = survivor.size
                feed(sched, ss, f)
                sched.tick()
                tick_ms["after"].append(sched.tick_ms[-1])
    refused = None
    if wl.retired:
        try:
            wl.step([], 1)
        except RuntimeError as e:
            refused = str(e)
    return {"lost_at": lost_at, "survivor_size": survivor_size,
            "retired": wl.retired, "refused": refused,
            "fired": list(inj.fired), "remeshes": wl.remeshes,
            "report_remeshes": sched.report()["aggregate"]["ft"]["remeshes"],
            "results": [_results(s) for s in ss],
            "ref": [_results(s) for s in ref], "tick_ms": tick_ms}


def ft_serve_rank(env, datas, drain_sizes=(1, 4)):
    """Every fault-tolerance scenario of one world size on this rank: the
    ``SERVE_CHAOS`` cases; ``PIPELINE_DRAIN`` (world sizes in
    ``drain_sizes``); on 4 ranks the batched frame under each channel-sum
    schedule (the default and the ring on the 4 ranks, the hierarchy on
    the (2, 2) group) and at width 1, and, last, the elastic remesh
    4 -> 2."""
    n = env.world_size
    mesh = env.group((2, 2), ("pod", "data")) if n == 4 else None
    out = {"chaos": serve_chaos_cases(env.world, datas)}
    if n in drain_sizes:
        out["drain"] = pipeline_drain_on(env.world)
    if n == 4:
        out["batched"] = {s: batched_frame_on(mesh if s == "hier22"
                                              else env.world, datas,
                                              schedule=s)
                          for s in ("psum", "p2p", "hier22")}
        out["batched"]["psum1"] = batched_frame_on(env.world, datas[:1])
        out["remesh"] = elastic_remesh_on(env, datas[:2])
    return out


# -- training ------------------------------------------------------------------

def grad_compress_rank(env, grads):
    """This rank's gradient (``grads[rank]``) through two steps of
    ``compressed_psum`` on the world, the second with the first's error
    feedback."""
    from repro_torch.train.grad_compress import compressed_psum
    g = torch.from_numpy(grads[env.rank])
    out, err = compressed_psum(g, env.world, torch.zeros_like(g))
    out2, _ = compressed_psum(g, env.world, err)
    return {"out": _np(out), "out2": _np(out2)}


# -- checkpoints ---------------------------------------------------------------

def ckpt_elastic_rank(env, ckpt_dir, tree, movie):
    """The elastic checkpoint paths on 4 ranks, as the JAX package's
    ``tests/test_ckpt_elastic.py`` runs them on 8 and 4 host devices.

    1. ``tree``, written at step 3 by one process, restored segmented:
       ``w`` and ``opt/m`` NATURAL on dim 0, ``opt/c`` CLONE; then
       re-saved (gathered, written by rank 0) at step 4
       and restored whole on every rank.
    2. The live ``FramePipeline`` carry: the uninterrupted 4-rank movie;
       the first half on 4 ranks, its carry gathered and checkpointed,
       restored whole on the survivor group of ranks 0-1, migrated onto
       a 2-rank ``Reconstructor`` and streamed on."""
    from repro_torch.ckpt import restore_sharded, save
    from repro_torch.ft import migrate_carry
    from repro_torch.ft.remesh import gather_carry
    from repro_torch.nlinv.recon import Reconstructor
    from repro_torch.nlinv.stream import FramePipeline
    comm = env.world
    like = {"w": torch.zeros(8, 8), "opt": {"m": torch.zeros(16),
                                           "c": torch.zeros(3, 2)}}
    seg, step = restore_sharded(ckpt_dir, like, {
        "w": (comm, Policy.NATURAL, 0),
        "opt": {"m": (comm, Policy.NATURAL, 0), "c": (comm, Policy.CLONE, 0)}})
    out = {"step": step, "w_local": _np(seg["w"].data),
           "m_local": _np(seg["opt"]["m"].data),
           "c_policy": seg["opt"]["c"].policy.name,
           "c_local": _np(seg["opt"]["c"].data)}
    whole = {"w": seg["w"].gather(), "opt": {"m": seg["opt"]["m"].gather(),
                                              "c": seg["opt"]["c"].data}}
    if env.rank == 0:
        save(ckpt_dir, 4, whole)
    comm.barrier()
    down, step4 = restore_sharded(ckpt_dir, like, "cpu")
    out.update(step4=step4, w_whole=_np(down["w"]),
               m_whole=_np(down["opt"]["m"]))

    y, masks, fov = movie
    half = y.shape[0] // 2
    rec4 = Reconstructor(comm, newton=2, cg_iters=6)
    ref, _ = FramePipeline(rec4, inflight=2).run(y, masks, fov)
    pipe4 = FramePipeline(Reconstructor(comm, newton=2, cg_iters=6),
                          inflight=2)
    first, _ = pipe4.run(y[:half], masks[:half], fov)
    carry = {k: gather_carry(comm, u) for k, u in pipe4.last_carry.items()}
    live = f"{ckpt_dir}/live"
    if env.rank == 0:
        save(live, half, carry)
    comm.barrier()
    comm2 = env.subgroup(2)
    out.update(ref=_np(ref), first=_np(first), second=None)
    if comm2 is None:
        return out
    host, step_live = restore_sharded(live, carry, "cpu")
    rec2 = Reconstructor(comm2, newton=2, cg_iters=6)
    carry2 = {k: migrate_carry(rec2, u) for k, u in host.items()}
    second, _ = FramePipeline(rec2, inflight=2).run(
        y[half:], masks[half:], fov, carry=carry2)
    out.update(step_live=step_live, second=_np(second))
    return out


# -- tensor-parallel serving -------------------------------------------------

SHARD_AXES = ("data", "model")


def serve_steps_on(cfg, params, tokens, enc, prefill_len, max_len,
                   mesh=None):
    """A prefill of ``tokens[:, :prefill_len]``, then one decode step for
    each later column of ``tokens`` (the same inputs on every path, so
    that each step's logits compare); the last-token logits of every step
    as numpy, whole ``(B, vocab)``."""
    from repro_torch.serve import make_serve_steps
    B = tokens.shape[0]
    prefill, decode, init_cache = make_serve_steps(
        cfg, mesh, max_len=max_len, batch=B,
        device="cpu" if mesh is None else None)
    tok = torch.from_numpy(tokens)
    lg, cache = prefill(params, tok[:, :prefill_len], init_cache(),
                        enc=None if enc is None else torch.from_numpy(enc))
    out = [_np(lg)]
    for pos in range(prefill_len, tokens.shape[1]):
        lg, cache = decode(params, tok[:, pos:pos + 1], cache, pos)
        out.append(_np(lg))
    return np.stack(out)


def sharded_serve_rank(env, meshes, cases):
    """Every case ``(arch, tree, tokens, enc, prefill_len, max_len)`` on
    each mesh shape of ``meshes`` (a ``(data, model)`` group of the first
    ranks; the ranks outside a mesh skip it): this rank's shards from the
    numpy tree (``convert.params_from_numpy(mesh=)``), the steps' logits
    and this rank's parameter bytes, keyed by (mesh, arch)."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import get_smoke
    from repro_torch.models import sharding
    out = {}
    for shape in meshes:
        comm = env.group(shape, SHARD_AXES)
        if comm is None:
            continue
        for arch, tree, tokens, enc, prefill_len, max_len in cases:
            cfg = dataclasses.replace(get_smoke(arch),
                                      compute_dtype="float32")
            params = convert.params_from_numpy(cfg, tree, mesh=comm)
            out[shape, arch] = {
                "logits": serve_steps_on(cfg, params, tokens, enc,
                                         prefill_len, max_len, mesh=comm),
                "bytes": sharding.param_bytes(params),
                "coords": comm.group.coords}
    return out


# -- sharded training ----------------------------------------------------------

TRAIN_KW = dict(base_lr=1e-3, warmup=0, total=10)


def _cuts(model, group) -> dict:
    """Each parameter's slice of its whole leaf ((start, stop) per dim)."""
    from repro_torch.models import sharding
    return {name: [(s.start, s.stop) for s in sharding.local_slices(
        _whole_shape(p, group), p.pspec, group)]
        for name, p in model.named_parameters()}


def _whole_shape(p, group) -> tuple:
    from repro_torch.models import sharding
    sizes = group.mesh_shape
    return tuple(n * math.prod(sizes[a] for a in sharding._axes(e))
                 for n, e in zip(p.shape, tuple(p.pspec) + (None,) * (
                     p.ndim - len(p.pspec))))


def _copy(t) -> np.ndarray:
    """A copy (the step updates the state in place)."""
    return np.array(_np(t))


def _opt_np(state) -> dict:
    return {k: {n: _copy(t) for n, t in state["opt"][k].items()}
            for k in ("m", "v")}


def _met_np(met) -> dict:
    return {k: float(v) for k, v in met.items()}


def train_steps_on(cfg, state, tokens, labels, enc, n, mesh=None, **kw):
    """``n`` steps of ``make_train_step(mesh=)`` on the same batch; each
    step's metrics, then the parameters (numpy, by name) and AdamW's
    moments after the first and after the last step."""
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, mesh=mesh, remat=kw.pop("remat", False),
                           **TRAIN_KW, **kw)
    tok, lab = torch.from_numpy(tokens), torch.from_numpy(labels)
    e = None if enc is None else torch.from_numpy(enc)
    mets, snaps = [], []
    for _ in range(n):
        state, met = step(state, tok, lab, e)
        mets.append(_met_np(met))
        snaps.append({"params": {k: _copy(p) for k, p in
                                 state["params"].named_parameters()},
                      **_opt_np(state)})
    return {"metrics": mets, "first": snaps[0], "last": snaps[-1]}


def grads_on(cfg, state, tokens, labels, enc, mesh=None, **kw):
    """The train step's gradients before its update (numpy, by name) and
    its loss."""
    from repro_torch.train.trainer import make_grad_fn
    grads = make_grad_fn(cfg, mesh=mesh, **kw)
    loss, met, g = grads(state, torch.from_numpy(tokens),
                         torch.from_numpy(labels),
                         None if enc is None else torch.from_numpy(enc))
    return {"loss": float(loss), **_met_np(met),
            "grads": {k: _np(v) for k, v in g.items()}}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def carried_opt(tree) -> dict:
    """A train state's AdamW part in the JAX tree layout, made from the
    parameters (``m = p / 2``, ``v = p * p``, step 3): moments that differ
    leaf by leaf, for the carry of ``convert.train_state_from_numpy``."""
    return {"m": _tree_map(lambda a: np.asarray(a) / 2, tree),
            "v": _tree_map(lambda a: np.square(np.asarray(a)), tree),
            "step": np.int32(3)}


def sharded_train_rank(env, meshes, cases, extra):
    """Every case ``(arch, tree, tokens, labels, enc)`` on each mesh shape of
    ``meshes`` (a ``(data, model)`` group of the first ranks; the ranks
    outside a mesh skip it): this rank's shards from the numpy tree
    (``convert.train_state_from_numpy(mesh=)``), the gradients, two steps,
    the bytes of params, ``m`` and ``v`` against the specs', and the
    moments of a carried state (``carried_opt``).
    ``extra`` maps a mesh shape to the cases' added runs on it:
    ``"microbatches"`` (one step with ``microbatches=2``) and ``"remat"``
    (the gradients with ``remat=True``)."""
    import dataclasses

    from repro_torch import convert
    from repro_torch.configs import get_smoke
    from repro_torch.models import sharding, transformer
    out = {}
    for shape in meshes:
        comm = env.group(shape, SHARD_AXES)
        if comm is None:
            continue
        group = comm.group
        for arch, tree, tokens, labels, enc in cases:
            cfg = dataclasses.replace(get_smoke(arch),
                                      compute_dtype="float32")

            def fresh():
                return convert.train_state_from_numpy(cfg, {"params": tree},
                                                      mesh=comm)

            state = fresh()
            res = {"cuts": _cuts(state["params"], group),
                   "coords": group.coords}
            res["grads"] = grads_on(cfg, state, tokens, labels, enc,
                                    mesh=comm, remat=False)
            if "remat" in extra.get(shape, ()):
                res["remat"] = grads_on(cfg, state, tokens, labels, enc,
                                        mesh=comm, remat=True)
            res["steps"] = train_steps_on(cfg, state, tokens, labels, enc, 2,
                                          mesh=comm)
            if "microbatches" in extra.get(shape, ()):
                res["mb2"] = train_steps_on(cfg, fresh(), tokens, labels,
                                            enc, 1, mesh=comm,
                                            microbatches=2)
            whole = transformer.Transformer(
                cfg, device="meta", expert_pad=state["params"].expert_pad)
            res["bytes"] = sharding.param_bytes(state["params"]) + sum(
                t.numel() * t.element_size() for k in ("m", "v")
                for t in state["opt"][k].values())
            res["spec_bytes"] = sharding.spec_bytes(cfg, whole,
                                                    group.mesh_shape)
            carried = convert.train_state_from_numpy(
                cfg, {"params": tree, "opt": carried_opt(tree)}, mesh=comm)
            res["carried"] = {**_opt_np(carried),
                              "step": int(carried["opt"]["step"])}
            out[shape, arch] = res
    return out


def recurrent_sharded_rank(env, meshes, serve_cases, train_cases):
    """The recurrent archs on each mesh: ``sharded_serve_rank``'s steps
    and parameter bytes, with this rank's cache bytes (``"cache_bytes"``),
    and ``sharded_train_rank``'s gradients and steps."""
    import dataclasses

    from repro_torch.configs import get_smoke
    from repro_torch.serve import make_serve_steps
    out = {"serve": sharded_serve_rank(env, meshes, serve_cases),
           "train": sharded_train_rank(env, meshes, train_cases, {})}
    for shape in meshes:
        comm = env.group(shape, SHARD_AXES)
        if comm is None:
            continue
        for arch, _, tokens, _, _, max_len in serve_cases:
            cfg = dataclasses.replace(get_smoke(arch),
                                      compute_dtype="float32")
            _, _, init_cache = make_serve_steps(cfg, comm, max_len=max_len,
                                                batch=tokens.shape[0])
            out["serve"][shape, arch]["cache_bytes"] = sum(
                t.numel() * t.element_size() for layer in init_cache()
                for part in layer.values() for t in part.values())
    return out


class CrashOnce:
    """A launcher's step hook that raises once, after step ``step``; each
    rank of a mesh holds its own copy, so every rank fails that step."""

    def __init__(self, step):
        self.step, self.crashed = step, 0

    def __call__(self, step, metrics):
        if step == self.step and not self.crashed:
            self.crashed += 1
            raise RuntimeError("simulated node failure")
