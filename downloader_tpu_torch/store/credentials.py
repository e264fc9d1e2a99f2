"""Environment credential chain for the object store.

Mirrors the reference's provider chain (uploader.go:45-49): generic
S3_ACCESS_KEY/S3_SECRET_KEY first (minio_credential_provider.go:21-37),
then the AWS env chain, then the MinIO env chain; if nothing resolves the
client runs anonymous/unsigned, as the reference's EnvGeneric falls back to
SignatureAnonymous (minio_credential_provider.go:27-30).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping


@dataclass(frozen=True)
class Credentials:
    access_key: str = ""
    secret_key: str = ""
    session_token: str = ""

    @property
    def anonymous(self) -> bool:
        return not (self.access_key and self.secret_key)


def from_env(environ: Mapping[str, str] | None = None) -> Credentials:
    env = os.environ if environ is None else environ
    chains = (
        ("S3_ACCESS_KEY", "S3_SECRET_KEY", ""),
        ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY", "AWS_SESSION_TOKEN"),
        ("MINIO_ACCESS_KEY", "MINIO_SECRET_KEY", ""),
    )
    for access_var, secret_var, token_var in chains:
        access, secret = env.get(access_var, ""), env.get(secret_var, "")
        if access and secret:
            return Credentials(
                access_key=access,
                secret_key=secret,
                session_token=env.get(token_var, "") if token_var else "",
            )
    return Credentials()
