"""Curve registry: short-Weierstrass parameters for the reference's 5 curves
(counterpart of icicle_tpu/curves/params.py; the port keeps its own copy of
the table, G2 parameters included).

Mirrors the constant tables in the reference's
``icicle/include/icicle/curves/params/{bn254,bls12_377,bls12_381,bw6_761,grumpkin}.h``
(generator coordinates, weierstrass ``b``) and the field pairings in
``curves/curve_config.h``. All curves have ``a = 0``, which lets every point op
use the complete (branchless) addition formulas of Renes-Costello-Batina 2015
(curves/group.py).

Values are the standard public parameters (verified by parsing the reference's
little-endian limb arrays); tests assert generators satisfy ``y^2 = x^3 + b``.
"""

from __future__ import annotations

import dataclasses
import functools

from icicle_tpu_torch.fields.field import Field, get_field


@dataclasses.dataclass(frozen=True)
class CurveParams:
    name: str
    base_field: str      # field of the point coordinates (fq)
    scalar_field: str    # group order field (fr)
    b: int               # weierstrass b (mod base field p)
    gen_x: int
    gen_y: int
    # G2 twist. g2_field "fp2" = quadratic extension Fq[u]/(u^2 - nonresidue);
    # "fq" = G2 lives over the base field itself (bw6_761). None = no G2.
    g2_field: str | None = None
    g2_b: tuple[int, int] | None = None
    g2_gen_x: tuple[int, int] | None = None
    g2_gen_y: tuple[int, int] | None = None


_CURVES: dict[str, CurveParams] = {}


def _def(p: CurveParams):
    _CURVES[p.name] = p


# reference: curves/params/bn254.h (gen=(1,2), b=3; G2 on Fp2, u^2=-1)
_def(CurveParams(
    name="bn254", base_field="bn254_base", scalar_field="bn254_scalar",
    b=3, gen_x=1, gen_y=2,
    g2_field="fp2",
    g2_b=(0x2B149D40CEB8AAAE81BE18991BE06AC3B5B4C5E559DBEFA33267E6DC24A138E5,
          0x009713B03AF0FED4CD2CAFADEED8FDF4A74FA084E52D1852E4A2BD0685C315D2),
    g2_gen_x=(0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,
              0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2),
    g2_gen_y=(0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA,
              0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B),
))

# reference: curves/params/bls12_377.h (b=1; G2 D-twist, b = u * const)
_def(CurveParams(
    name="bls12_377", base_field="bls12_377_base", scalar_field="bls12_377_scalar",
    b=1,
    gen_x=0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    gen_y=0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    g2_field="fp2",
    g2_b=(0,
          0x010222F6DB0FD6F343BD03737460C589DC7B4F91CD5FD889129207B63C6BF8000DD39E5C1CCCCCCD1C9ED9999999999A),
    g2_gen_x=(0x018480BE71C785FEC89630A2A3841D01C565F071203E50317EA501F557DB6B9B71889F52BB53540274E3E48F7C005196,
              0x00EA6040E700403170DC5A51B1B140D5532777EE6651CECBE7223ECE0799C9DE5CF89984BFF76FE6B26BFEFA6EA16AFE),
    g2_gen_y=(0x00690D665D446F7BD960736BCBB2EFB4DE03ED7274B49A58E458C282F832D204F2CF88886D8C7C2EF094094409FD4DDF,
              0x00F8169FD28355189E549DA3151A70AA61EF11AC3D591BF12463B01ACEE304C24279B83F5E52270BD9A1CDD185EB8F93),
))

# reference: curves/params/bls12_381.h (b=4; G2 M-twist, b = 4(1+u))
_def(CurveParams(
    name="bls12_381", base_field="bls12_381_base", scalar_field="bls12_381_scalar",
    b=4,
    gen_x=0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB,
    gen_y=0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1,
    g2_field="fp2",
    g2_b=(4, 4),
    g2_gen_x=(0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
              0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E),
    g2_gen_y=(0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
              0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE),
))

# reference: curves/params/bw6_761.h (b=-1; G2 is a curve over Fq itself, b=4;
# scalar field = bls12_377 base field)
_def(CurveParams(
    name="bw6_761", base_field="bw6_761_base", scalar_field="bw6_761_scalar",
    b=-1,
    gen_x=0x1075B020EA190C8B277CE98A477BEAEE6A0CFB7551B27F0EE05C54B85F56FC779017FFAC15520AC11DBFCD294C2E746A17A54CE47729B905BD71FA0C9EA097103758F9A280CA27F6750DD0356133E82055928ACA6AF603F4088F3AF66E5B43D,
    gen_y=0x58B84E0A6FC574E6FD637B45CC2A420F952589884C9EC61A7348D2A2E573A3265909F1AF7E0DBAC5B8FA1771B5B806CC685D31717A4C55BE3FB90B6FC2CDD49F9DF141B3053253B2B08119CAD0FB93AD1CB2BE0B20D2A1BAFC8F2DB4E95363,
    g2_field="fq",
    g2_b=(4, 0),
    g2_gen_x=(0x110133241D9B816C852A82E69D660F9D61053AAC5A7115F4C06201013890F6D26B41C5DAB3DA268734EC3F1F09FEB58C5BBCAE9AC70E7C7963317A300E1B6BACE6948CB3CD208D700E96EFBC2AD54B06410CF4FE1BF995BA830C194CD025F1C,
              0),
    g2_gen_y=(0x17C3357761369F8179EB10E4B6D2DC26B7CF9ACEC2181C81A78E2753FFE3160A1D86C80B95A59C94C97EB733293FEF64F293DBD2C712B88906C170FFA823003EA96FCD504AFFC758AA2D3A3C5A02A591EC0594F9EAC689EB70A16728C73B61,
              0),
))

# reference: curves/params/grumpkin.h (b=-17, gen=(1, sqrt(-16)); the bn254
# 2-cycle: base field = bn254 scalar field; MSM-only curve, no G2)
_def(CurveParams(
    name="grumpkin", base_field="grumpkin_base", scalar_field="grumpkin_scalar",
    b=-17, gen_x=1,
    gen_y=0x00000002CF135E7506A45D632D270D45F1181294833FC48D823F272C,
))


class Curve:
    """Named curve binding base/scalar Field objects + derived constants."""

    def __init__(self, params: CurveParams):
        self.params = params
        self.name = params.name
        self.fq: Field = get_field(params.base_field)
        self.fr: Field = get_field(params.scalar_field)
        self.b = params.b % self.fq.modulus
        self.b3 = (3 * params.b) % self.fq.modulus
        self.gen_x = params.gen_x
        self.gen_y = params.gen_y
        self.scalar_bits = self.fr.modulus.bit_length()


@functools.lru_cache(maxsize=None)
def get_curve(name: str) -> Curve:
    if name not in _CURVES:
        raise KeyError(f"unknown curve {name!r}; known: {sorted(_CURVES)}")
    return Curve(_CURVES[name])


def curve_names() -> list[str]:
    return sorted(_CURVES)
