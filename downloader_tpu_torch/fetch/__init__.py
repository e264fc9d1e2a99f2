from .http import TransferError  # noqa: F401
