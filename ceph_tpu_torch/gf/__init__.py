"""GF(2^8) tables and coding matrices (host numpy), re-exported at the
package as the JAX package re-exports its own."""
from .tables import (  # noqa: F401
    GF_POLY,
    gf_exp,
    gf_log,
    gf_mul,
    gf_mul_scalar,
    gf_div,
    gf_inv,
    gf_pow,
    MUL_TABLE,
    gf_mult_bitmatrix,
    expand_to_bitmatrix,
)
from .matrices import (  # noqa: F401
    gf_gen_rs_matrix,
    gf_gen_cauchy1_matrix,
    jerasure_reed_sol_van_matrix,
    gf_invert_matrix,
    gf_matmul,
)
