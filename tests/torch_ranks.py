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

def _solve(comm, d, newton, cg, mode, fused=True, fov_scale=1.0):
    from repro_torch.nlinv.operators import sobolev_weight
    from repro_torch.nlinv.recon import Reconstructor, pad_channels
    rec = Reconstructor(comm, newton=newton, cg_iters=cg, channel_sum=mode,
                        fused=fused)
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


def nlinv_on(comm, d, cases):
    """One frame per ``(newton, cg, channel_sum, fused[, fov_scale])``
    case on ``comm``'s ranks; each rank's image, its ``rho``'s bits, the
    gathered ``chat`` and the CG log."""
    return {case: _solve(comm, d, *case) for case in cases}


def nlinv_rank(env, d, cases):
    return nlinv_on(env.world, d, cases)


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
