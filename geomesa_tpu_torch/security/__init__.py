"""Security layer: visibility expressions and authorization providers.

Port of ``geomesa_tpu/security/__init__.py``: Accumulo-style boolean
visibility expressions per feature (``a&(b|c)``, VisibilityEvaluator.scala;
recursive descent here) and the AuthorizationsProvider SPI. Features carry
their visibility in the ``__vis__`` column; a query keeps the rows whose
expression the store's authorizations satisfy.
"""

from geomesa_tpu_torch.security.visibility import (
    AuthorizationsProvider,
    DefaultAuthorizationsProvider,
    VisibilityEvaluator,
    VisibilityError,
    visibility_mask,
)

__all__ = [
    "AuthorizationsProvider",
    "DefaultAuthorizationsProvider",
    "VisibilityEvaluator",
    "VisibilityError",
    "visibility_mask",
]
