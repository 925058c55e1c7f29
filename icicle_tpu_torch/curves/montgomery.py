"""Montgomery-form conversion API for point arrays (counterpart of
icicle_tpu/curves/montgomery.py; reference src/curves/montgomery_conversion.cpp
-- affine/projective, G1/G2 variants).

Montgomery form is the in-kernel representation already; these are the
explicit API-boundary converters the reference exposes. G2 raises in
`get_group` (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

from icicle_tpu_torch.curves.group import Projective, get_group


def affine_to_montgomery(curve_name: str, x, y, g2: bool = False):
    f = get_group(curve_name, g2=g2).coord_field
    return f.to_mont(x), f.to_mont(y)


def affine_from_montgomery(curve_name: str, x, y, g2: bool = False):
    f = get_group(curve_name, g2=g2).coord_field
    return f.from_mont(x), f.from_mont(y)


def projective_to_montgomery(curve_name: str, p: Projective, g2: bool = False):
    f = get_group(curve_name, g2=g2).coord_field
    return Projective(f.to_mont(p.x), f.to_mont(p.y), f.to_mont(p.z))


def projective_from_montgomery(curve_name: str, p: Projective, g2: bool = False):
    f = get_group(curve_name, g2=g2).coord_field
    return Projective(f.from_mont(p.x), f.from_mont(p.y), f.from_mont(p.z))
