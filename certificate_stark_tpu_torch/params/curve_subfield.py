"""A copy of certificate_stark_tpu/params/curve_subfield.py.

Subfield-b Cheetah-f63 instance (scripts/find_subfield_curve.py).
Same curve form y^2 = x^3 + x + b as the reference (a=1 tower),
with b in F_p so the group order is computable. See DESIGN.md.
"""

B0 = 57  # curve: y^2 = x^3 + x + B0 (b3 = 3*B0)
TRACE_FP = 943175350  # trace of Frobenius over F_p
N1 = 4719772408541104460  # number of points over F_p
N6 = 11054175187819007980211544512849345932037236387574519889203501835514273397280325525647066138173234153843507434400  # number of points over F_p6
SCALAR_Q = 22276251592877471244676635097473735673  # 125-bit prime scalar field (new part of N6)
COFACTOR = 496231385326669155213469327702128793845343815061054884769246743693194352800
