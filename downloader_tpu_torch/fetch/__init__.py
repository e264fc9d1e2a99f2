from .dispatch import (  # noqa: F401
    Backend,
    BackendRegistration,
    DispatchClient,
    ProgressFn,
    UnsupportedJobError,
)
from .http import HTTPBackend, TransferError  # noqa: F401
