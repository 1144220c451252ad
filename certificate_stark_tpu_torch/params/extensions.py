"""Extension-field towers over f63 for the quadratic and cubic proof options.
A copy of certificate_stark_tpu/params/extensions.py:

  quadratic: f63[x] / (x^2 - 3)        (3 is the smallest non-residue)
  cubic:     f63[x] / (x^3 - 3x - 1)   (the smallest irreducible trinomial;
                                        every binomial x^3 - c is reducible)
"""

QUAD_NONRESIDUE = 3          # x^2 = 3
CUBIC_A1 = 3                 # x^3 = 3x + 1
CUBIC_A0 = 1
