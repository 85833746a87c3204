"""Typed autoscaler errors.

Reference counterpart: cluster-autoscaler/utils/errors — AutoscalerError with
an error-type discriminant (CloudProviderError, ApiCallError, InternalError,
TransientError, ConfigurationError) so callers can decide between backoff,
retry, and abort without string matching.
"""

from __future__ import annotations

from enum import Enum


class ErrorType(Enum):
    CLOUD_PROVIDER = "cloudProviderError"
    API_CALL = "apiCallError"
    INTERNAL = "internalError"
    TRANSIENT = "transientError"
    CONFIGURATION = "configurationError"


class AutoscalerError(Exception):
    def __init__(self, error_type: ErrorType, msg: str):
        super().__init__(msg)
        self.error_type = error_type

    def prefixed(self, prefix: str) -> "AutoscalerError":
        """Wrap with context, keeping the type (reference: AddPrefix)."""
        return AutoscalerError(self.error_type, f"{prefix}{self}")

    @property
    def retriable(self) -> bool:
        return self.error_type in (ErrorType.TRANSIENT, ErrorType.API_CALL)


def to_autoscaler_error(default_type: ErrorType, err: Exception) -> AutoscalerError:
    """reference: errors.ToAutoscalerError — idempotent wrapping."""
    if isinstance(err, AutoscalerError):
        return err
    return AutoscalerError(default_type, str(err))
