"""The port's scanner and store against the JAX package's.

Each test drives both packages on the same input: scan results over
the scanner's fixture trees, SigV4 signatures for fixed clocks and
keys, object keys, and S3 uploads across packages (the port's client
into the reference's stub and the reference's client into the port's
stub), for a single PUT and for a multipart upload.
"""

import io
import os

import numpy as np
import pytest

from downloader_tpu.scan import MEDIA_EXTENSIONS as REF_MEDIA_EXTENSIONS
from downloader_tpu.scan import scan_dir as ref_scan_dir
from downloader_tpu.store import Credentials as RefCredentials
from downloader_tpu.store import S3Client as RefS3Client
from downloader_tpu.store import sigv4 as ref_sigv4
from downloader_tpu.store.stub import S3Stub as RefS3Stub
from downloader_tpu.store.uploader import object_key as ref_object_key
from downloader_tpu_torch.scan import MEDIA_EXTENSIONS, scan_dir
from downloader_tpu_torch.store import Credentials, S3Client, sigv4
from downloader_tpu_torch.store.stub import S3Stub
from downloader_tpu_torch.store.uploader import object_key

SCAN_TREES = {
    "movie_at_root": ["movie.mkv", "movie.srt"],
    "single_top_level_dir": ["movie/movie.mkv", "movie/info.nfo"],
    "season_dirs": ["season 1/e1.mkv", "season 2/e1.mkv", "fake dir/commentary.mkv"],
    "s_regex_dir": ["s01/e1.mp4", "extras/bonus.mkv"],
    "two_top_level_dirs": ["a/x.mkv", "b/y.mkv"],
    "nested_seasons": ["Show/season 1/e1.webm", "Show/deleted scenes/d.mkv"],
    "every_extension": ["m.mp4", "m.mkv", "m.mov", "m.webm", "m.avi", "m.txt",
                        "m.mkv.part", "mkv"],
    "sorted": ["season 1/b.mkv", "season 1/a.mkv", "S02/c.mov", "s3/subs.srt"],
    "decoys": ["Show.S01E01.mkv", "Show.S01E01.srt", "sample/sample.mkv",
               "season 10/e.mkv", "s1x/e.mkv"],
}


def _build(root, layout):
    for rel in layout:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_bytes(b"x")
    return root


def _relative(root, results):
    return [os.path.relpath(str(path), str(root)) for path in results]


@pytest.mark.parametrize("tree", sorted(SCAN_TREES))
def test_scan_dir_matches_reference(tmp_path, tree):
    root = _build(tmp_path, SCAN_TREES[tree])
    port = _relative(root, scan_dir(str(root)))
    assert port == _relative(root, ref_scan_dir(str(root)))
    assert port == sorted(port)


def test_scan_of_a_symlink_loop_matches_reference(tmp_path):
    root = _build(tmp_path, ["season 1/e1.mkv"])
    (root / "season 2").symlink_to(root)
    assert _relative(root, scan_dir(str(root))) == ["season 1/e1.mkv"]
    assert _relative(root, ref_scan_dir(str(root))) == ["season 1/e1.mkv"]


def test_media_extensions_match_reference():
    assert MEDIA_EXTENSIONS == REF_MEDIA_EXTENSIONS


SIGV4_CASES = [
    # (method, path, query, headers, payload hash, key id, secret,
    #  region, amz date)
    ("GET", "/", {}, {"host": "127.0.0.1:9000"}, "UNSIGNED-PAYLOAD",
     "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY", "us-east-1",
     "20150830T123600Z"),
    ("PUT", "/triton-staging/episode-1/original/U2hvdy5TMDFFMDEubWt2",
     {"partNumber": "3", "uploadId": "abc/def=="},
     {"host": "s3.local", "x-amz-content-sha256": "e3b0c442",
      "Content-Type": "  application/octet-stream  "},
     "e3b0c44298fc1c149afbf4c8996fb92427ae41e4649b934ca495991b7852b855",
     "ak", "sk", "eu-west-2", "20261016T000000Z"),
    ("POST", "/b/k with space/ünï", {"uploads": ""}, {"Host": "h:1", "X-Amz-Date": "x"},
     "UNSIGNED-PAYLOAD", "ak2", "sk2", "us-west-1", "20261231T235959Z"),
]


@pytest.mark.parametrize("case", range(len(SIGV4_CASES)))
def test_sigv4_signature_matches_reference(case):
    args = SIGV4_CASES[case]
    method, path, query, headers, payload_hash, access, secret, region, date = args
    port = sigv4.sign(method, path, query, headers, payload_hash, access,
                      secret, region, "s3", date)
    ref = ref_sigv4.sign(method, path, query, headers, payload_hash, access,
                         secret, region, "s3", date)
    assert port == ref
    assert port.startswith(f"AWS4-HMAC-SHA256 Credential={access}/{date[:8]}/{region}/s3/")
    assert sigv4.canonical_request(method, path, query, headers, payload_hash) == (
        ref_sigv4.canonical_request(method, path, query, headers, payload_hash)
    )


@pytest.mark.parametrize(
    "name",
    ["Show.S01E01.mkv", "Amélie (2001).mkv", "進撃の巨人 S01E01.mp4",
     "a b+c=d&e.webm", "season 1/e1.mkv", "ünï/cödé.mov"],
)
def test_object_key_matches_reference(name):
    path = os.path.join("/downloads", "media-9", name)
    assert object_key("media-9", path) == ref_object_key("media-9", path)


def _upload(client_cls, creds_cls, stub, payload):
    client = client_cls.from_endpoint_url(
        f"http://{stub.endpoint}", creds_cls(access_key="ak", secret_key="sk")
    )
    client.make_bucket("triton-staging")
    client.put_object(
        "triton-staging", "episode-1/original/U2hvdy5TMDFFMDEubWt2",
        io.BytesIO(payload), len(payload),
    )
    return {
        bucket: dict(objects) for bucket, objects in stub.buckets.items()
    }


@pytest.mark.parametrize(
    "size,threshold,part_size,multiparts",
    [(300_001, None, None, 0), (3 * 1024 * 1024 + 17, 1024 * 1024, 1024 * 1024, 1)],
    ids=["single-put", "multipart"],
)
def test_upload_across_packages(monkeypatch, size, threshold, part_size, multiparts):
    if threshold is None:
        monkeypatch.delenv("S3_MULTIPART_THRESHOLD", raising=False)
        monkeypatch.delenv("S3_PART_SIZE", raising=False)
    else:
        monkeypatch.setenv("S3_MULTIPART_THRESHOLD", str(threshold))
        monkeypatch.setenv("S3_PART_SIZE", str(part_size))
    payload = np.random.default_rng(size).integers(0, 256, size, np.uint8).tobytes()
    stored = {}
    for name, client_cls, creds_cls, stub_cls, stub_creds in (
        ("port client, reference stub", S3Client, Credentials, RefS3Stub,
         RefCredentials),
        ("reference client, port stub", RefS3Client, RefCredentials, S3Stub,
         Credentials),
    ):
        with stub_cls(credentials=stub_creds(access_key="ak", secret_key="sk")) as stub:
            stored[name] = _upload(client_cls, creds_cls, stub, payload)
            assert stub.completed_multiparts == multiparts, name
            assert stub.list_multipart_uploads("triton-staging") == [], name
    port, ref = stored.values()
    assert port == ref
    assert port["triton-staging"]["episode-1/original/U2hvdy5TMDFFMDEubWt2"] == payload
