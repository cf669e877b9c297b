"""Small-matrix linear algebra: closed-form determinants.

Equivalent of the reference's ``linalg.hpp:26-229`` (closed-form 1x1..4x4
determinants with an LU fallback).  The 4x4 cofactors are expanded
explicitly — batched and branch-free, in any dtype — instead of
``jnp.linalg.det``'s LU decomposition.
"""

import jax.numpy as jnp


def det2(m):
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def det3(m):
    return (
        m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1])
        - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 0])
        + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0])
    )


def det4(m):
    """Cofactor expansion along row 0 with shared 2x2 minors of rows 2,3."""
    c01 = m[..., 2, 0] * m[..., 3, 1] - m[..., 2, 1] * m[..., 3, 0]
    c02 = m[..., 2, 0] * m[..., 3, 2] - m[..., 2, 2] * m[..., 3, 0]
    c03 = m[..., 2, 0] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 0]
    c12 = m[..., 2, 1] * m[..., 3, 2] - m[..., 2, 2] * m[..., 3, 1]
    c13 = m[..., 2, 1] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 1]
    c23 = m[..., 2, 2] * m[..., 3, 3] - m[..., 2, 3] * m[..., 3, 2]

    m00 = m[..., 1, 1] * c23 - m[..., 1, 2] * c13 + m[..., 1, 3] * c12
    m01 = m[..., 1, 0] * c23 - m[..., 1, 2] * c03 + m[..., 1, 3] * c02
    m02 = m[..., 1, 0] * c13 - m[..., 1, 1] * c03 + m[..., 1, 3] * c01
    m03 = m[..., 1, 0] * c12 - m[..., 1, 1] * c02 + m[..., 1, 2] * c01

    return (
        m[..., 0, 0] * m00
        - m[..., 0, 1] * m01
        + m[..., 0, 2] * m02
        - m[..., 0, 3] * m03
    )


def det(m):
    """Dispatch by trailing square-matrix size (linalg.hpp:214-229)."""
    n = m.shape[-1]
    if n == 1:
        return m[..., 0, 0]
    if n == 2:
        return det2(m)
    if n == 3:
        return det3(m)
    if n == 4:
        return det4(m)
    return jnp.linalg.det(m)
