import os as _os

from .logging import get_logger, configure_from_env  # noqa: F401


def flag_from_env(name: str, environ=None) -> bool:
    """Boolean env knob, default ON: 'off'/'0'/'false'/'no'/'disabled'
    (any case) disables; anything else — including unset — enables."""
    env = _os.environ if environ is None else environ
    return env.get(name, "").strip().lower() not in (
        "off",
        "0",
        "false",
        "no",
        "disabled",
    )


def zero_copy_from_env(environ=None) -> bool:
    """ZEROCOPY env knob: disables the splice/sendfile data paths — an
    operator escape hatch for filesystems where they misbehave."""
    return flag_from_env("ZEROCOPY", environ)
