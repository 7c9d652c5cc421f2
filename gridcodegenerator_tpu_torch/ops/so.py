"""Second-order derivatives: the IDSVA-SO and FDSVA-SO tensor suites.

The counterpart of ``gridcodegenerator_tpu/ops/so.py``, in its analytical,
loop-unrolled form only: the spatial-vector-algebra second-order algorithm
(world-frame forward quantities S, v, a, psi-dot, psi-ddot, S-dot; composite
IC, body-Coriolis BC and force f accumulated towards the root; the D1-D4 and
T1-T4 operators), then nine outer-product stages over (joint j, ancestor
a in ancestors(j) + [j], subtree member st of j) triples and the p1-p6
cross-product corrections. The stage loops run in Python over the model's
topology tuples, each entry a (B...) lane tensor. FDSVA-SO composes the
IDSVA-SO tensors with the forward-dynamics gradient by the implicit-function
identity.

Output layout, both suites: (4, nv, nv, nv, B...) =
[d2/dq2, d2/dqd2, d2/dqd dq, dM/dq] (IDSVA-SO, of tau) and
[d2qdd/dq2, d2qdd/dqd2, d2qdd/dqd dq, dMinv/dq] (FDSVA-SO), where
cross[i, j, k] = d2_i / dqd_j dq_k.
"""

from __future__ import annotations

import torch

from ..models.model import RobotModel
from .common import DEFAULT_GRAVITY, check_fixed_base, gravity_accel
from .fd_grad import fd_grad
from .spatial import bmm, bmv, dot6
from .xforms import all_xmats


# ---------------------------------------------------------------------------
# spatial helpers (6-vectors (6, B...), operators (6, 6, B...))
# ---------------------------------------------------------------------------

# the JAX package's refusal (``gridcodegenerator_tpu/ops/so.py:61-66``)
FIXED_BASE_ONLY = ("second-order tensors are fixed-base (matching the "
                   "reference: floating-base robots get only ID/Minv/FD and "
                   "their gradients)")


def _sk(a, b, c, z):
    return [[z, -c, b], [c, z, -a], [-b, a, z]]


def _crm_mat(v):
    """Full motion cross-product matrix (6, 6, B...) of v (6, B...)."""
    z = torch.zeros_like(v[0])
    W = _sk(v[0], v[1], v[2], z)
    V = _sk(v[3], v[4], v[5], z)
    rows = [torch.stack(W[r] + [z, z, z]) for r in range(3)]
    rows += [torch.stack(V[r] + W[r]) for r in range(3)]
    return torch.stack(rows)


def _icrf_mat(f):
    """icrf(f) such that crf(w) f = icrf(f) w."""
    z = torch.zeros_like(f[0])
    N = _sk(f[0], f[1], f[2], z)
    H = _sk(f[3], f[4], f[5], z)
    rows = [torch.stack([-x for x in N[r]] + [-x for x in H[r]])
            for r in range(3)]
    rows += [torch.stack([-x for x in H[r]] + [z, z, z]) for r in range(3)]
    return torch.stack(rows)


def _xinv_motion(X):
    """Inverse of a motion transform: the blockwise transpose of its 3x3
    blocks."""
    TL = X[:3, :3].transpose(0, 1)
    BL = X[3:, :3].transpose(0, 1)
    BR = X[3:, 3:].transpose(0, 1)
    top = torch.cat([TL, torch.zeros_like(TL)], dim=1)
    bot = torch.cat([BL, BR], dim=1)
    return torch.cat([top, bot], dim=0)


# ---------------------------------------------------------------------------
# stage quantities
# ---------------------------------------------------------------------------

def _sva_so_stages(model: RobotModel, q, qd, qdd, gravity):
    """Forward/backward second-order stage quantities, per-joint lists."""
    check_fixed_base(model, FIXED_BASE_ONLY)
    n = model.n
    bshape = qd.shape[1:]
    Xs = all_xmats(model, q)
    g = gravity_accel(gravity, qd).expand((6,) + bshape)
    par, Sind = model.parent, model.S_ind

    Xup = [None] * n
    for i in range(n):
        Xup[i] = Xs[i] if par[i] == -1 else bmm(Xs[i], Xup[par[i]])
    S = [_xinv_motion(Xup[i])[:, Sind[i]] for i in range(n)]

    v, a, psid, psidd, Sd = ([None] * n for _ in range(5))
    crm_v = [None] * n
    zero6 = torch.zeros((6,) + bshape, dtype=qd.dtype, device=qd.device)
    for i in range(n):
        p = par[i]
        vp = v[p] if p != -1 else zero6
        ap = a[p] if p != -1 else g
        vJ = S[i] * qd[i]
        v[i] = vp + vJ
        crm_v[i] = _crm_mat(v[i])
        aJ = S[i] * qdd[i] + (bmv(crm_v[p], vJ) if p != -1 else zero6)
        a[i] = ap + aJ
        psid[i] = bmv(crm_v[p], S[i]) if p != -1 else zero6
        if p == -1:
            psidd[i] = bmv(_crm_mat(g), S[i])
        else:
            psidd[i] = bmv(_crm_mat(ap), S[i]) + bmv(crm_v[p], psid[i])
        Sd[i] = bmv(crm_v[i], S[i])

    IC = [torch.einsum("ki...,kl,lj...->ij...", Xup[i], model.Imat[i], Xup[i])
          for i in range(n)]
    BC, f = [None] * n, [None] * n
    for i in range(n):
        ICv = bmv(IC[i], v[i])
        crf_vi = -crm_v[i].transpose(0, 1)
        BC[i] = bmm(crf_vi, IC[i]) + _icrf_mat(ICv) - bmm(IC[i], crm_v[i])
        f[i] = bmv(IC[i], a[i]) + bmv(crf_vi, ICv)
    for i in range(n - 1, -1, -1):
        p = par[i]
        if p != -1:
            IC[p] = IC[p] + IC[i]
            BC[p] = BC[p] + BC[i]
            f[p] = f[p] + f[i]

    D1, D2, D3, D4 = ([None] * n for _ in range(4))
    T1, T2, T3, T4, crfSIC = ([None] * n for _ in range(5))
    crm_S = [_crm_mat(S[i]) for i in range(n)]
    crm_psid = [_crm_mat(psid[i]) for i in range(n)]
    for i in range(n):
        crf_Si = -crm_S[i].transpose(0, 1)
        crf_psidi = -crm_psid[i].transpose(0, 1)
        ICS = bmv(IC[i], S[i])
        ICpsid = bmv(IC[i], psid[i])
        D1[i] = bmm(crf_Si, IC[i]) - bmm(IC[i], crm_S[i])
        D2[i] = (bmm(crf_psidi, IC[i]) + _icrf_mat(ICpsid)
                 - bmm(IC[i], crm_psid[i])
                 + bmm(crf_Si, BC[i]) - bmm(BC[i], crm_S[i]))
        D3[i] = D1[i] + _icrf_mat(ICS)
        D4[i] = _icrf_mat(ICS)
        T1[i] = ICS
        T2[i] = -bmv(BC[i].transpose(0, 1), S[i])
        T3[i] = (bmv(BC[i], psid[i]) + bmv(IC[i], psidd[i])
                 + bmv(_icrf_mat(f[i]), S[i]))
        T4[i] = bmv(BC[i], S[i]) + bmv(IC[i], psid[i] + Sd[i])
        crfSIC[i] = bmm(crf_Si, IC[i])

    return dict(S=S, v=v, a=a, psid=psid, psidd=psidd, Sd=Sd,
                IC=IC, BC=BC, f=f, D1=D1, D2=D2, D3=D3, D4=D4,
                T1=T1, T2=T2, T3=T3, T4=T4,
                crm_S=crm_S, crm_psid=crm_psid, crfSIC=crfSIC)


# ---------------------------------------------------------------------------
# IDSVA-SO
# ---------------------------------------------------------------------------

def idsva_so_analytical(model: RobotModel, q, qd, qdd,
                        gravity: float = DEFAULT_GRAVITY,
                        return_stages: bool = False):
    """Analytical second-order inverse dynamics: (4, nv, nv, nv, B...)
    [d2tau/dq2, d2tau/dqd2, d2tau/dqd dq, dM/dq]. Entries the stages never
    write are zero; the statement order below is the algorithm's (several
    entries are accumulated or overwritten)."""
    n = model.n
    st_ = _sva_so_stages(model, q, qd, qdd, gravity)
    S, psid, psidd, Sd = (st_[k] for k in ("S", "psid", "psidd", "Sd"))
    D1, D2, D3, D4 = st_["D1"], st_["D2"], st_["D3"], st_["D4"]
    T1, T2, T3, T4 = st_["T1"], st_["T2"], st_["T3"], st_["T4"]
    crm_S, crm_psid, crfSIC = st_["crm_S"], st_["crm_psid"], st_["crfSIC"]

    dq2, dqd2, dvdq, dM = {}, {}, {}, {}

    def triples():
        for j in range(n):
            for a_ in list(model.ancestors[j]) + [j]:
                for st in model.subtree[j]:
                    yield j, a_, st

    _Dv = {}

    def Dv(fam, Dlist, st, vec_list, k):
        """Memoized D-operator action Dlist[st] vec_list[k]."""
        key = (fam, st, k)
        if key not in _Dv:
            _Dv[key] = bmv(Dlist[st], vec_list[k])
        return _Dv[key]

    psid_Sd = [psid[i] + Sd[i] for i in range(n)]

    # t1 = outer(S_j, psid_a)
    for j, a_, st in triples():
        val3 = dot6(S[j], Dv("3p", D3, st, psid, a_))
        dvdq[st, a_, j] = -val3
        if j != st:
            val2 = dot6(S[j], Dv("2p", D2, st, psid, a_))
            dq2[j, st, a_] = val2
            dq2[j, a_, st] = val2
            dvdq[j, a_, st] = val3
    # t2 = outer(S_j, S_a)
    for j, a_, st in triples():
        v3 = dot6(S[j], Dv("3S", D3, st, S, a_))
        if a_ < j:
            dqd2[st, j, a_] = -v3
            dqd2[st, a_, j] = -v3
        elif a_ == j:
            dqd2[st, j, j] = -dot6(S[j], Dv("1S", D1, st, S, j))
        if j != st:
            dqd2[j, st, a_] = v3
            dqd2[j, a_, st] = v3
            dvdq[j, st, a_] = dot6(S[j], Dv("2S", D2, st, S, a_))
    # t3 = outer(psid_j, psid_a)
    for j, a_, st in triples():
        v3 = dot6(psid[j], Dv("3p", D3, st, psid, a_))
        dq2[st, a_, j] = -v3
        if a_ < j:
            dq2[st, j, a_] = -v3
    # t4 = outer(S_j, psidd_a)
    for j, a_, st in triples():
        if j != st:
            v1 = dot6(S[j], Dv("1pp", D1, st, psidd, a_))
            dq2[j, st, a_] = dq2[j, st, a_] + v1
            dq2[j, a_, st] = dq2[j, a_, st] + v1
    # t5 = outer(S_j, (Sd + psid)_a)
    for j, a_, st in triples():
        if j != st:
            dvdq[j, st, a_] = dvdq[j, st, a_] + dot6(
                S[j], Dv("1sp", D1, st, psid_Sd, a_))
    # t6 = outer(S_a, psid_j)
    for j, a_, st in triples():
        if a_ < j:
            v3 = dot6(S[a_], Dv("3p", D3, st, psid, j))
            dvdq[st, j, a_] = -v3
            dq2[a_, j, st] = dot6(S[a_], Dv("2p", D2, st, psid, j))
            dvdq[a_, j, st] = v3
    # t7 = outer(S_a, psidd_j)
    for j, a_, st in triples():
        if a_ < j:
            dq2[a_, j, st] = dq2[a_, j, st] + dot6(
                S[a_], Dv("1pp", D1, st, psidd, j))
    # t8 = outer(S_a, S_j)
    for j, a_, st in triples():
        if a_ < j:
            v4 = dot6(S[a_], Dv("4S", D4, st, S, j))
            dM[a_, j, st] = v4
            dM[st, j, a_] = v4
            if st != j:
                v3 = dot6(S[a_], Dv("3S", D3, st, S, j))
                dqd2[a_, j, st] = v3
                dqd2[a_, st, j] = v3
                dvdq[a_, st, j] = dot6(S[a_], Dv("2S", D2, st, S, j))
        if j != st:
            v1 = dot6(S[a_], Dv("1S", D1, st, S, j))
            dM[a_, st, j] = v1
            dM[j, st, a_] = v1
    # t9 = outer(S_a, (Sd + psid)_j)
    for j, a_, st in triples():
        if a_ < j and st != j:
            dvdq[a_, st, j] = dvdq[a_, st, j] + dot6(
                S[a_], Dv("1sp", D1, st, psid_Sd, j))
            dq2[a_, st, j] = dq2[a_, j, st]
    # p1..p6 corrections over (joint, ancestor) pairs
    for j in range(n):
        for a_ in list(model.ancestors[j]) + [j]:
            p1 = bmv(crm_psid[a_], S[j])
            p2 = bmv(_crm_mat(psidd[a_]), S[j])
            p3 = bmv(crm_S[a_], S[j])
            p4 = (bmv(_crm_mat(psid_Sd[a_]), S[j])
                  - 2.0 * bmv(crm_psid[j], S[a_]))
            p5 = bmv(crm_S[j], S[a_])
            for st in model.subtree[j]:
                c12 = -dot6(p1, T2[st]) + dot6(p2, T1[st])
                dq2[st, a_, j] = dq2[st, a_, j] + c12
                if a_ < j:
                    dq2[st, j, a_] = dq2[st, j, a_] + c12
                    dvdq[st, j, a_] = (dvdq[st, j, a_]
                                       - dot6(p3, T2[st]) + dot6(p4, T1[st]))
                    c5 = dot6(p5, T3[st])
                    dq2[a_, j, st] = dq2[a_, j, st] - c5
                    if st != j:
                        dq2[a_, st, j] = dq2[a_, st, j] - c5
                    dvdq[a_, j, st] = dvdq[a_, j, st] - dot6(p5, T4[st])
            if a_ < j:
                p6 = (bmv(crm_S[a_].transpose(0, 1), T1[j])
                      + bmv(crfSIC[j].transpose(0, 1), S[a_]))
                dqd2[a_, j, j] = dot6(p6, S[j])

    # cross and dM store entry (i, a, b) at [i, b, a] (the oracle layout)
    out = torch.zeros((4, n, n, n) + qd.shape[1:], dtype=qd.dtype,
                      device=qd.device)
    for c, d, transpose in ((0, dq2, False), (1, dqd2, False),
                            (2, dvdq, True), (3, dM, True)):
        for (i, x, y), val in d.items():
            out[(c, i, y, x) if transpose else (c, i, x, y)] = val
    if return_stages:
        stages = {k: torch.stack(st_[k]) for k in (
            "v", "a", "psid", "psidd", "Sd", "IC", "BC", "f",
            "T1", "T2", "T3", "T4")}
        stages["idsva_so"] = out
        return out, stages
    return out


def idsva_so(model: RobotModel, q, qd, qdd, gravity: float = DEFAULT_GRAVITY):
    """Second-order inverse dynamics at (q, qd, qdd): (4, nv, nv, nv, B...).
    ``qdd`` is required (the realized accelerations the tensors belong
    to)."""
    if qdd is None:
        raise ValueError("idsva_so: qdd is required")
    return idsva_so_analytical(model, q, qd, qdd, gravity)


# ---------------------------------------------------------------------------
# FDSVA-SO
# ---------------------------------------------------------------------------

def _minv_contract(Mi, T):
    """out[i,j,k,B] = sum_m Mi[i,m,B] T[m,j,k,B] (unrolled over m)."""
    out = Mi[:, 0][:, None, None] * T[0][None]
    for m in range(1, Mi.shape[0]):
        out = out + Mi[:, m][:, None, None] * T[m][None]
    return out


def _dm_contract(dM, D):
    """C[i,a,b,B] = sum_m dM[i,m,a,B] D[m,b,B] (unrolled over m)."""
    out = dM[:, 0][:, :, None] * D[0][None, None]
    for m in range(1, dM.shape[0]):
        out = out + dM[:, m][:, :, None] * D[m][None, None]
    return out


def fdsva_compose(T, df_du, Mi):
    """The FDSVA-SO implicit-function contractions, given the IDSVA-SO stack
    T (4, nv, nv, nv, B...), df_du (nv, 2nv, B...) and Minv (nv, nv, B...):

        d2qdd/dq2     = -Minv (d2tau/dq2 + C + C^T_jk),  C[ijk] = dM[imj] dfdq[mk]
        d2qdd/dqd2    = -Minv  d2tau/dqd2
        d2qdd/dqd dq  = -Minv (d2tau/dqd dq + dM[imk] dfdqd[mj])
        d2qdd/dtau dq = -Minv (dM[imk] Minv[mj])          (= dMinv/dq)
    """
    nv = Mi.shape[0]
    dfdq, dfdqd = df_du[:, :nv], df_du[:, nv:]
    d2tau_q, d2tau_qd, tau_cross, dM = T[0], T[1], T[2], T[3]
    C = _dm_contract(dM, dfdq)
    inner_q = d2tau_q + C + C.transpose(1, 2)
    inner_cross = tau_cross + _dm_contract(dM, dfdqd).transpose(1, 2)
    inner_tau = _dm_contract(dM, Mi).transpose(1, 2)
    return torch.stack([-_minv_contract(Mi, inner_q),
                        -_minv_contract(Mi, d2tau_qd),
                        -_minv_contract(Mi, inner_cross),
                        -_minv_contract(Mi, inner_tau)])


def fdsva_compose_lanes(T, df_du, Mi, chunk_bytes: int = 1 << 28):
    """``fdsva_compose`` in place on T, lane-major (..., L), a chunk of lanes
    at a time, each chunk's temporaries about ``chunk_bytes`` a (4, n, n, n)
    stack. A chunk goes lane-first once, its contractions are two batched
    matrix products over its lanes (dM against [dfdq | dfdqd | Minv], then
    Minv against the four inner stacks), and it goes back into T. Returns
    T, now the FDSVA-SO stack. The composed route of
    ``ops/cuda/kernels.py:fdsva_so`` (the JAX package's route above 16
    joints, ``gridcodegenerator_tpu/ops/pallas/kernels.py:fdsva_so_pallas``,
    composes on XLA too)."""
    n, L = Mi.shape[0], Mi.shape[-1]
    step = max(1, chunk_bytes // (4 * n ** 3 * T.element_size()))
    for a in range(0, L, step):
        t = T[..., a:a + step]
        c = t.shape[-1]
        tl = t.permute(4, 0, 1, 2, 3).contiguous()         # (c, 4, n, n, n)
        M = Mi[..., a:a + step].permute(2, 0, 1)           # (c, n, n)
        D = torch.cat([df_du[..., a:a + step], Mi[..., a:a + step]],
                      dim=1).permute(2, 0, 1)              # (c, n, 3n)
        # R[c, i, a, :] = sum_m dM[i, m, a] [dfdq | dfdqd | Minv][m, :]
        R = torch.bmm(tl[:, 3].transpose(2, 3).reshape(c, n * n, n),
                      D).reshape(c, n, n, 3 * n)
        C = R[..., :n]
        inner = torch.stack([tl[:, 0] + C + C.transpose(2, 3), tl[:, 1],
                             tl[:, 2] + R[..., n:2 * n].transpose(2, 3),
                             R[..., 2 * n:].transpose(2, 3)], dim=2)
        del R, C, tl
        out = torch.bmm(M, inner.reshape(c, n, 4 * n * n))
        t.copy_(out.reshape(c, n, 4, n, n).permute(2, 1, 3, 4, 0).neg_())
    return T


def fdsva_so_unrolled(model: RobotModel, q, qd, u,
                      gravity: float = DEFAULT_GRAVITY):
    """FDSVA-SO from the IDSVA-SO tensors at qdd = FD(q, qd, u)."""
    check_fixed_base(model, FIXED_BASE_ONLY)
    df_du, qdd, Mi = fd_grad(model, q, qd, u, gravity, return_extras=True)
    T = idsva_so_analytical(model, q, qd, qdd, gravity)
    return fdsva_compose(T, df_du, Mi)


def fdsva_so(model: RobotModel, q, qd, u,
             gravity: float = DEFAULT_GRAVITY):
    """Second-order forward dynamics: (4, nv, nv, nv, B...)
    [d2qdd/dq2, d2qdd/dqd2, d2qdd/dqd dq, d2qdd/dtau dq]."""
    return fdsva_so_unrolled(model, q, qd, u, gravity)

