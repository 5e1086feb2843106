"""Equivariant machinery: real spherical harmonics, real Clebsch-Gordan
couplings, and real Wigner rotation matrices, on PyTorch.

The JAX package's ``repro.models.gnn.equivariant``, function for function.
The coefficient tables are precomputed in numpy (complex arithmetic allowed
at build time) by a copy of the reference's code, so they are the same
floats; runtime work is tensor einsums and vector ops over edges.

Conventions: real SH basis indexed m = -l..l with
  Y_{l,-|m|} ∝ sin(|m|φ), Y_{l,0}, Y_{l,|m|} ∝ cos(|m|φ),
Condon–Shortley included in the associated Legendre recurrence and cancelled in
the real combination (standard "real SH" normalization, orthonormal on S²).
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Real spherical harmonics (vectorized associated-Legendre recurrence)
# ---------------------------------------------------------------------------


def real_sph_harm(l_max: int, vecs, eps: float = 1e-12, xp=torch):
    """Y[e, i] for unit(ish) vectors vecs [E, 3]; i enumerates (l, m) pairs with
    l = 0..l_max, m = -l..l (size (l_max+1)²). Orthonormal real SH. ``xp`` is
    ``torch`` for tensors or ``numpy`` for arrays (the Wigner samples)."""
    r = xp.sqrt(xp.sum(vecs**2, axis=-1) + eps)
    x, y, z = vecs[:, 0] / r, vecs[:, 1] / r, vecs[:, 2] / r
    ct = z  # cosθ
    st = xp.sqrt(xp.clip(1.0 - ct**2, 0.0, 1.0))
    phi = xp.arctan2(y, x)

    # associated Legendre P_l^m(cosθ) with Condon-Shortley, m >= 0
    P: dict[tuple[int, int], object] = {(0, 0): xp.ones_like(ct)}
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = (
                (2 * l - 1) * ct * P[(l - 1, m)] - (l + m - 1) * P[(l - 2, m)]
            ) / (l - m)

    cols = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt(
                (2 * l + 1) / (4 * math.pi)
                * math.factorial(l - am) / math.factorial(l + am)
            )
            if m == 0:
                cols.append(norm * P[(l, 0)])
            elif m > 0:
                cols.append(math.sqrt(2) * norm * P[(l, m)] * xp.cos(m * phi))
            else:
                cols.append(math.sqrt(2) * norm * P[(l, am)] * xp.sin(am * phi))
    # a non-negative axis: torch 2.11 mislays a DTensor stacked at axis -1
    return xp.stack(cols, axis=cols[0].ndim)


def irreps_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


def l_slices(l_max: int) -> list[slice]:
    out, o = [], 0
    for l in range(l_max + 1):
        out.append(slice(o, o + 2 * l + 1))
        o += 2 * l + 1
    return out


# ---------------------------------------------------------------------------
# Clebsch-Gordan in the real basis
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _cg_complex(l1: int, l2: int, l3: int) -> np.ndarray:
    """⟨l1 m1 l2 m2 | l3 m3⟩ via the Racah formula (exact Python ints)."""
    f = math.factorial
    C = np.zeros((2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1))
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return C
    pref = (2 * l3 + 1) * f(l3 + l1 - l2) * f(l3 - l1 + l2) * f(l1 + l2 - l3) / f(l1 + l2 + l3 + 1)
    for m1 in range(-l1, l1 + 1):
        for m2 in range(-l2, l2 + 1):
            m3 = m1 + m2
            if abs(m3) > l3:
                continue
            pre = math.sqrt(
                pref
                * f(l3 + m3) * f(l3 - m3)
                * f(l1 + m1) * f(l1 - m1)
                * f(l2 + m2) * f(l2 - m2)
            )
            s = 0.0
            kmin = max(0, l2 - l3 - m1, l1 - l3 + m2)
            kmax = min(l1 + l2 - l3, l1 - m1, l2 + m2)
            for k in range(kmin, kmax + 1):
                s += (-1) ** k / (
                    f(k) * f(l1 + l2 - l3 - k) * f(l1 - m1 - k)
                    * f(l2 + m2 - k) * f(l3 - l2 + m1 + k) * f(l3 - l1 - m2 + k)
                )
            C[m1 + l1, m2 + l2, m3 + l3] = pre * s
    return C


@lru_cache(maxsize=None)
def _real_to_complex(l: int) -> np.ndarray:
    """U with Y^complex_{l,m} = Σ_{m'} U[m, m'] Y^real_{l,m'} (both −l..l)."""
    U = np.zeros((2 * l + 1, 2 * l + 1), dtype=complex)
    s2 = 1 / math.sqrt(2)
    # m>0: Y_m = (-1)^m (Y^r_{|m|} + i Y^r_{-|m|})/√2 ; m<0: (Y^r_{|m|} − i Y^r_{-|m|})/√2
    for m in range(-l, l + 1):
        i = m + l
        if m == 0:
            U[i, l] = 1.0
        elif m > 0:
            U[i, l + m] = (-1) ** m * s2
            U[i, l - m] = 1j * (-1) ** m * s2
        else:
            U[i, l + abs(m)] = s2
            U[i, l - abs(m)] = -1j * s2
    return U


@lru_cache(maxsize=None)
def real_cg(l1: int, l2: int, l3: int) -> np.ndarray | None:
    """Real-basis coupling C[m1, m2, m3]: (x ⊗ y)_{l3} = C · x_{l1} y_{l2} is
    equivariant for real-SH-basis irreps. None when the triangle rule fails."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        return None
    cg = _cg_complex(l1, l2, l3)
    U1, U2, U3 = _real_to_complex(l1), _real_to_complex(l2), _real_to_complex(l3)
    # C_real = U1† U2† CG U3 contracted appropriately (einsum over complex bases)
    C = np.einsum("abe,ai,bj,ek->ijk", cg.astype(complex), U1, U2, U3.conj())
    # result is purely real or purely imaginary depending on parity; take the
    # nonzero part and keep it real
    if np.abs(C.imag).max() > np.abs(C.real).max():
        C = C.imag
    else:
        C = C.real
    return np.ascontiguousarray(C)


@lru_cache(maxsize=None)
def cg_tensor(l1: int, l2: int, l3: int, dtype: torch.dtype, device) -> torch.Tensor:
    """:func:`real_cg` as a ``[(2l1+1)(2l2+1), 2l3+1]`` tensor on ``device``,
    made once per (path, dtype, device)."""
    C = real_cg(l1, l2, l3)
    return torch.as_tensor(C.reshape(-1, C.shape[-1]), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Real Wigner rotation matrices — exact sampling construction
# ---------------------------------------------------------------------------
#
# D^l(R) is defined by Y_l(R v) = D^l(R) · Y_l(v). With a fixed generic sample
# set {v_i} (precomputed, with the pseudo-inverse of A_l[i, m] = Y_l(v_i)_m),
# evaluating Y at the rotated samples gives D^l = (A_l⁺ B_l)ᵀ exactly, fully
# vectorized over edges — no fragile recurrences, validated by the
# rotation-equivariance property tests.


@lru_cache(maxsize=None)
def _wigner_samples(l_max: int) -> tuple[np.ndarray, list[np.ndarray]]:
    rng = np.random.default_rng(12345)
    n = 2 * (l_max + 1) ** 2  # oversample ×2 for conditioning
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    Y = real_sph_harm(l_max, v, xp=np)  # [n, dim] (pure numpy)
    pinvs = []
    for l, sl in enumerate(l_slices(l_max)):
        A = Y[:, sl]  # [n, 2l+1]
        pinvs.append(np.linalg.pinv(A))  # [2l+1, n]
    return v, pinvs


def wigner_d_real(l_max: int, rot: torch.Tensor) -> list[torch.Tensor]:
    """Real-SH rotation matrices D^l[..., 2l+1, 2l+1], l = 0..l_max, for
    rotations ``rot`` [..., 3, 3] acting on column vectors."""
    v, pinvs = _wigner_samples(l_max)
    vj = torch.as_tensor(v, dtype=rot.dtype, device=rot.device)  # [n, 3]
    rv = torch.einsum("...ij,nj->...ni", rot, vj)  # rotated samples
    B = real_sph_harm(l_max, rv.reshape(-1, 3)).reshape(rot.shape[:-2] + (v.shape[0], -1))
    out = []
    for l, sl in enumerate(l_slices(l_max)):
        Bl = B[..., sl]  # [..., n, 2l+1]
        pinv = torch.as_tensor(pinvs[l], dtype=rot.dtype, device=rot.device)
        Dt = torch.einsum("mn,...nk->...mk", pinv, Bl)
        out.append(Dt.transpose(-1, -2))  # D^l = (A⁺B)ᵀ
    return out


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch.linalg.cross`` over the last dim. Over a mesh (DTensor
    operands) it runs in ``local_map`` on ``a``'s layout, whose last dim
    (3) no axis divides: torch 2.11 has no sharding strategy for
    ``linalg_cross``."""
    if hasattr(a, "placements"):  # a DTensor
        from torch.distributed.tensor.experimental import local_map

        pl = tuple(a.placements)
        return local_map(lambda x, y: torch.linalg.cross(x, y, dim=-1), out_placements=(pl,),
                         in_placements=(pl, pl), device_mesh=a.device_mesh,
                         redistribute_inputs=True)(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotation_to_edge_frame(vecs: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rotation matrices [E,3,3] mapping each edge direction to +z (the eSCN
    edge-aligned frame)."""
    r = torch.sqrt(torch.sum(vecs**2, dim=-1, keepdim=True) + eps)
    n = vecs / r
    z = n
    # pick a helper axis not parallel to n
    helper = torch.where(
        n[:, 2:3].abs() < 0.9,
        torch.tensor([0.0, 0.0, 1.0], dtype=vecs.dtype, device=vecs.device),
        torch.tensor([1.0, 0.0, 0.0], dtype=vecs.dtype, device=vecs.device),
    )
    xaxis = _cross(helper, z)
    xaxis = xaxis / torch.sqrt(torch.sum(xaxis**2, -1, keepdim=True) + eps)
    yaxis = _cross(z, xaxis)
    # rows = new basis vectors → R @ n = e_z
    return torch.stack([xaxis, yaxis, z], dim=z.dim() - 1)  # dim -2 (see real_sph_harm)
