"""The port's fleet data plane (store/cas.py + fetch/singleflight.py)
against the JAX package's.

Mirrors ``tests/test_singleflight.py`` over both packages:

- content identity: ``content_key`` coalesces trivially different
  spellings of one object, and both packages give the same keys;
- the content-addressed store: verified round trips, LRU order under
  the byte bound, TTL expiry, corrupt entries evicted and never served,
  lease-pinned entries never evicted (a store full of pinned entries
  refuses admission), ledger accounting that balances to zero;
- the election: one leader per key, nonce-checked release, stale-lease
  promotion, the in-process two-thread coalesce, and every failpoint
  seam's degrade path;
- the fleet walks: a real 2-worker fleet of each package drains a flash
  crowd of identical jobs with ONE origin GET, and a seeded SIGKILL of
  the coalesce leader mid-fetch promotes a follower. Both packages'
  fleets run one after the other on the same job stream and must store
  the same objects, publish the same Converts and report the same
  amplification on ``/debug/flows``.

The last tests drive the port's one-process ``serve()``: with
``CACHE_DIR`` alone (no ``SINGLEFLIGHT_DIR``) it serves a second job
from the cache, and each of the six knobs of the data plane and the
fleet heartbeat changes what it does.
"""

import contextlib
import json
import os
import threading
import time

import pytest

from test_torch_analysis import torch_protocol_guard  # noqa: F401  (module guards)
from test_torch_daemon import free_port, stop_planes
from test_torch_fleet import (
    BUCKET,
    PACKAGE_IDS,
    PACKAGES,
    PORT,
    ConvertSink,
    Origin,
    fleet_isolation,  # noqa: F401  (autouse: ledger balance, federation reset)
    http_get,
    payload,
    publish_job,
    stored,
    wait,
    worker_env,
)


@pytest.fixture(params=PACKAGES, ids=PACKAGE_IDS)
def pkg(request):
    return request.param


def counter(pkg, name: str) -> float:
    return pkg.metrics.GLOBAL.snapshot().get(name, 0)


# -- content identity ------------------------------------------------------------


def test_content_key_normalizes_equivalent_spellings(pkg):
    content_key = pkg.cas.content_key
    base = content_key("http://example.com/a/b?q=1")
    assert content_key("HTTP://Example.com:80/a/b?q=1") == base
    assert content_key("http://example.com/a/b?q=1#frag") == base
    assert content_key("https://example.com/a/b?q=1") != base
    assert content_key("http://example.com:8080/a/b?q=1") != base
    assert content_key("http://example.com/a/b?q=2") != base
    assert content_key("http://example.com/a/c?q=1") != base
    # the other package keys the same URL the same way
    other = PACKAGES[1] if pkg is PACKAGES[0] else PACKAGES[0]
    assert other.cas.content_key("HTTP://Example.com:80/a/b?q=1#x") == base


def test_content_key_magnet_collapses_to_infohash(pkg):
    content_key = pkg.cas.content_key
    infohash = "C0FFEE" + "0" * 34
    one = content_key(f"magnet:?xt=urn:btih:{infohash}&dn=name-a&tr=http://t1/a")
    two = content_key(f"magnet:?xt=urn:btih:{infohash.lower()}&dn=name-b&tr=http://t2/a")
    assert one == two
    assert content_key("magnet:?xt=urn:btih:" + "1" * 40) != one
    other = PACKAGES[1] if pkg is PACKAGES[0] else PACKAGES[0]
    assert other.cas.content_key(f"magnet:?xt=urn:btih:{infohash}") == one


# -- the content-addressed store -------------------------------------------------


@pytest.fixture
def store(pkg, tmp_path):
    cache = pkg.cas.ContentStore(str(tmp_path / "cache"), max_bytes=64 * 1024 * 1024,
                                 ttl_s=3600.0)
    yield cache
    cache.close()


def put(cache, key, body, name="artifact.bin", tmp_dir="/tmp"):
    source = os.path.join(tmp_dir, f"src-{key[:8]}")
    with open(source, "wb") as fh:
        fh.write(body)
    try:
        return cache.put(key, source, url="http://o/x", name=name)
    finally:
        os.unlink(source)


def test_store_round_trip_verifies_and_serves(pkg, store, tmp_path):
    body = payload(4096, 1)
    key = pkg.cas.content_key("http://origin/hot.mp4")
    assert store.lookup(key) is None  # cold miss
    assert put(store, key, body, name="hot.bin", tmp_dir=str(tmp_path))
    hit = store.lookup(key)
    assert hit is not None
    assert hit.name == "hot.bin"
    assert hit.size == len(body)
    with open(hit.path, "rb") as fh:
        assert fh.read() == body
    snap = store.snapshot()
    assert snap["entries"] == 1
    assert snap["bytes"] == len(body)
    assert snap["hits"] == 1 and snap["misses"] == 1


def test_store_corrupt_entry_evicted_never_served(pkg, store, tmp_path):
    body = payload(4096, 2)
    key = pkg.cas.content_key("http://origin/corrupt.bin")
    assert put(store, key, body, tmp_dir=str(tmp_path))
    # flip the stored bytes behind the meta's back (same size, so only
    # the digest verify can catch it)
    data_path = store.lookup(key).path
    with open(data_path, "r+b") as fh:
        fh.write(b"\x00" * 16)
    before = counter(pkg, "cache_corrupt_evictions_total")
    assert store.lookup(key) is None, "a corrupt entry must never serve"
    assert counter(pkg, "cache_corrupt_evictions_total") == before + 1
    assert not os.path.exists(data_path)
    # the refetch path admits cleanly again
    assert put(store, key, body, tmp_dir=str(tmp_path))
    assert store.lookup(key) is not None


def test_store_ttl_expiry_evicts(pkg, store, tmp_path):
    key = pkg.cas.content_key("http://origin/stale.bin")
    assert put(store, key, payload(1024, 3), tmp_dir=str(tmp_path))
    meta_path = store._meta_path(key)
    with open(meta_path, encoding="utf-8") as fh:
        meta = json.load(fh)
    meta["created"] = time.time() - 7200.0  # past the 3600s TTL
    with open(meta_path, "w", encoding="utf-8") as fh:
        json.dump(meta, fh)
    assert store.lookup(key) is None
    assert store.snapshot()["entries"] == 0


def test_store_torn_put_swept_on_lookup(store):
    key = "ab" + "0" * 62
    data = store._data_path(key)
    os.makedirs(os.path.dirname(data), exist_ok=True)
    with open(data, "wb") as fh:
        fh.write(b"torn")
    assert store.lookup(key) is None
    assert not os.path.exists(data), "meta-less data file must be swept"


def test_store_lru_eviction_order(pkg, tmp_path):
    body = payload(1024, 4)
    cache = pkg.cas.ContentStore(str(tmp_path / "cache"), max_bytes=3 * 1024, ttl_s=0)
    try:
        keys = [f"{index:02d}" + "0" * 62 for index in range(3)]
        now = time.time()
        for index, key in enumerate(keys):
            assert put(cache, key, body, tmp_dir=str(tmp_path))
            # pin distinct LRU clocks: keys[0] coldest
            os.utime(cache._data_path(key), (now - 100 + index, now - 100 + index))
        # a hit REFRESHES keys[0]'s clock, making keys[1] the victim
        assert cache.lookup(keys[0]) is not None
        newcomer = "ff" + "0" * 62
        assert put(cache, newcomer, body, tmp_dir=str(tmp_path))
        survivors = {key for key in keys + [newcomer]
                     if os.path.exists(cache._data_path(key))}
        assert survivors == {keys[0], keys[2], newcomer}
    finally:
        cache.close()


def test_store_pinned_entries_never_evicted_refuses_admission(pkg, tmp_path):
    body = payload(1024, 5)
    pins: set = set()
    cache = pkg.cas.ContentStore(str(tmp_path / "cache"), max_bytes=2 * 1024, ttl_s=0,
                                 pinned=lambda key: key in pins)
    try:
        leader, follower = "aa" + "0" * 62, "bb" + "0" * 62
        assert put(cache, leader, body, tmp_dir=str(tmp_path))
        assert put(cache, follower, body, tmp_dir=str(tmp_path))
        pins.update({leader, follower})
        before = counter(pkg, "cache_admit_refusals_total")
        newcomer = "cc" + "0" * 62
        assert not put(cache, newcomer, body, tmp_dir=str(tmp_path)), (
            "a store full of leased entries must refuse, not evict")
        assert counter(pkg, "cache_admit_refusals_total") == before + 1
        assert os.path.exists(cache._data_path(leader))
        assert os.path.exists(cache._data_path(follower))
        # unpinning makes LRU room again
        pins.discard(leader)
        assert put(cache, newcomer, body, tmp_dir=str(tmp_path))
        assert not os.path.exists(cache._data_path(leader))
    finally:
        cache.close()


def test_store_refuses_under_ledger_scratch_pressure(pkg, tmp_path):
    """The cache rides the scratch-disk budget of the admission ledger:
    when the ledger cannot grant the charge and every entry is
    lease-pinned, admission is refused."""
    body = payload(1024, 6)
    pkg.admission.LEDGER.configure({"disk": 2 * 1024})
    pins: set = set()
    cache = pkg.cas.ContentStore(str(tmp_path / "cache"), max_bytes=0, ttl_s=0,
                                 pinned=lambda key: key in pins)
    try:
        first = "aa" + "0" * 62
        assert put(cache, first, body, tmp_dir=str(tmp_path))
        pins.add(first)
        second = "bb" + "0" * 62
        assert put(cache, second, body, tmp_dir=str(tmp_path))
        pins.add(second)
        third = "cc" + "0" * 62
        assert not put(cache, third, body, tmp_dir=str(tmp_path))
        assert os.path.exists(cache._data_path(first))
        assert os.path.exists(cache._data_path(second))
        # releasing a lease lets eviction refund its charge and admit
        pins.discard(first)
        assert put(cache, third, body, tmp_dir=str(tmp_path))
        assert not os.path.exists(cache._data_path(first))
    finally:
        cache.close()


def test_store_close_refunds_without_deleting(pkg, store, tmp_path):
    key = pkg.cas.content_key("http://origin/persist.bin")
    assert put(store, key, payload(1024, 7), tmp_dir=str(tmp_path))
    assert pkg.admission.LEDGER.outstanding()
    store.close()
    assert not pkg.admission.LEDGER.outstanding()
    assert os.path.exists(store._data_path(key)), "close() leaves artifacts for the next life"


# -- the lease registry ----------------------------------------------------------


def test_lease_election_one_leader(pkg, tmp_path):
    registry = pkg.singleflight.LeaseRegistry(str(tmp_path / "inflight"), lease_ttl_s=30.0)
    key = "aa" + "0" * 62
    lease = registry.acquire_lease(key, url="http://o/x")
    assert lease is not None and not lease.promoted
    assert registry.acquire_lease(key) is None, "a live lease excludes"
    assert registry.is_leased(key)
    registry.release_lease(lease)
    assert not registry.is_leased(key)
    second = registry.acquire_lease(key)
    assert second is not None and not second.promoted
    registry.release_lease(second)
    registry.release_lease(second)  # idempotent


def test_lease_stale_promotion_and_zombie_release(pkg, tmp_path):
    root = str(tmp_path / "inflight")
    dead = pkg.singleflight.LeaseRegistry(root, lease_ttl_s=5.0, instance="worker-dead")
    heir = pkg.singleflight.LeaseRegistry(root, lease_ttl_s=5.0, instance="worker-heir")
    key = "aa" + "0" * 62
    zombie = dead.acquire_lease(key)
    assert zombie is not None
    stale = time.time() - 60.0
    os.utime(zombie.path, (stale, stale))
    before = counter(pkg, "singleflight_promotions_total")
    promoted = heir.acquire_lease(key)
    assert promoted is not None and promoted.promoted
    assert counter(pkg, "singleflight_promotions_total") == before + 1
    # the zombie waking up late must NOT tear down its successor
    dead.release_lease(zombie)
    assert heir.is_leased(key), "zombie release tore down the new lease"
    dead.beat(zombie)
    record = heir.peek(key)
    assert record is not None and record["owner"] == "worker-heir"
    heir.release_lease(promoted)
    assert not heir.is_leased(key)


def test_lease_beat_keeps_claim_fresh(pkg, tmp_path):
    registry = pkg.singleflight.LeaseRegistry(str(tmp_path / "inflight"), lease_ttl_s=5.0)
    key = "aa" + "0" * 62
    lease = registry.acquire_lease(key)
    assert lease is not None
    old = time.time() - 4.0
    os.utime(lease.path, (old, old))
    registry.beat(lease)
    record = registry.peek(key)
    assert record is not None and record["age_s"] < 1.0
    registry.release_lease(lease)


# -- the coalescing plane (in-process) -------------------------------------------


class StubBackend:
    supports_cache = True
    supports_mirrors = False

    def __init__(self, body: bytes, gate=None):
        self.body = body
        self.gate = gate
        self.started = threading.Event()
        self.downloads = 0
        self._lock = threading.Lock()

    def download(self, token, job_dir, progress, url):
        with self._lock:
            self.downloads += 1
        self.started.set()
        if self.gate is not None:
            assert self.gate.wait(timeout=30.0), "test gate never opened"
        with open(os.path.join(job_dir, "artifact.bin"), "wb") as fh:
            fh.write(self.body)

    def fetch_small(self, token, job_dir, progress, url, max_bytes):
        self.download(token, job_dir, progress, url)
        return True


def make_plane(pkg, tmp_path, wait_s=30.0, lease_ttl_s=30.0):
    store = pkg.cas.ContentStore(str(tmp_path / "cache"), max_bytes=64 * 1024 * 1024,
                                 ttl_s=3600.0)
    registry = pkg.singleflight.LeaseRegistry(str(tmp_path / "inflight"),
                                              lease_ttl_s=lease_ttl_s)
    return pkg.singleflight.CoalescingDataPlane(store, registry, wait_s=wait_s, poll_s=0.02)


def test_plane_covers_only_opted_in_http_backends(pkg, tmp_path):
    plane = make_plane(pkg, tmp_path)
    try:
        backend = StubBackend(b"x")
        assert plane.covers(backend, "http://o/a")
        assert plane.covers(backend, "https://o/a")
        assert not plane.covers(backend, "magnet:?xt=urn:btih:" + "1" * 40)
        assert not plane.covers(object(), "http://o/a")
    finally:
        plane.store.close()


def test_plane_coalesces_two_concurrent_jobs_into_one_fetch(pkg, tmp_path):
    body = payload(8192, 8)
    gate = threading.Event()
    backend = StubBackend(body, gate=gate)
    plane = make_plane(pkg, tmp_path)
    url = "http://origin/coalesce.bin"
    dirs = [str(tmp_path / f"job-{index}") for index in range(2)]
    for job_dir in dirs:
        os.makedirs(job_dir)
    results = [None, None]

    def run(index):
        results[index] = plane.download(backend, None, dirs[index], lambda u, p: None, url)

    joins_before = counter(pkg, "singleflight_joins_total")
    try:
        leader = threading.Thread(target=run, args=(0,), daemon=True)
        leader.start()
        assert backend.started.wait(timeout=10.0)
        follower = threading.Thread(target=run, args=(1,), daemon=True)
        follower.start()
        wait(lambda: counter(pkg, "singleflight_joins_total") > joins_before, 10.0,
             "the follower to join the in-flight fetch")
        gate.set()
        leader.join(timeout=30.0)
        follower.join(timeout=30.0)
        assert not leader.is_alive() and not follower.is_alive()
        assert results == [True, True]
        assert backend.downloads == 1, "two jobs must cost ONE fetch"
        for job_dir in dirs:
            with open(os.path.join(job_dir, "artifact.bin"), "rb") as fh:
                assert fh.read() == body
        # a third, later job is a plain cache hit
        third = str(tmp_path / "job-2")
        os.makedirs(third)
        assert plane.download(backend, None, third, lambda u, p: None, url)
        assert backend.downloads == 1
    finally:
        gate.set()
        plane.store.close()


def test_plane_small_lane_serves_from_cache(pkg, tmp_path):
    body = payload(2048, 9)
    backend = StubBackend(body)
    plane = make_plane(pkg, tmp_path)
    try:
        for index in range(2):
            job_dir = str(tmp_path / f"job-{index}")
            os.makedirs(job_dir)
            assert plane.fetch_small(backend, None, job_dir, lambda u, p: None,
                                     "http://origin/small.bin", 1 << 20)
            with open(os.path.join(job_dir, "artifact.bin"), "rb") as fh:
                assert fh.read() == body
        assert backend.downloads == 1
    finally:
        plane.store.close()


def test_failpoint_cas_lookup_forces_miss(pkg, tmp_path):
    plane = make_plane(pkg, tmp_path)
    url = "http://origin/forced-miss.bin"
    job_dir = str(tmp_path / "job-0")
    os.makedirs(job_dir)
    try:
        assert plane.download(StubBackend(payload(1024, 10)), None, job_dir,
                              lambda u, p: None, url)
        pkg.failpoints.FAILPOINTS.configure("cas.lookup=fail")
        assert plane.store.lookup(pkg.cas.content_key(url)) is None
    finally:
        pkg.failpoints.FAILPOINTS.reset()
        plane.store.close()


def test_failpoint_cas_put_completes_job_uncached(pkg, tmp_path):
    body = payload(1024, 11)
    plane = make_plane(pkg, tmp_path)
    url = "http://origin/enospc.bin"
    job_dir = str(tmp_path / "job-0")
    os.makedirs(job_dir)
    try:
        pkg.failpoints.FAILPOINTS.configure("cas.put=fail")
        assert plane.download(StubBackend(body), None, job_dir, lambda u, p: None, url), (
            "write-through failure must not fail the job")
        with open(os.path.join(job_dir, "artifact.bin"), "rb") as fh:
            assert fh.read() == body
        pkg.failpoints.FAILPOINTS.reset()
        assert plane.store.lookup(pkg.cas.content_key(url)) is None, (
            "the entry must not have landed")
    finally:
        pkg.failpoints.FAILPOINTS.reset()
        plane.store.close()


def test_failpoint_coalesce_join_degrades_to_direct_fetch(pkg, tmp_path):
    plane = make_plane(pkg, tmp_path)
    url = "http://origin/join-fail.bin"
    job_dir = str(tmp_path / "job-0")
    os.makedirs(job_dir)
    lease = plane.registry.acquire_lease(pkg.cas.content_key(url))
    assert lease is not None
    try:
        pkg.failpoints.FAILPOINTS.configure("coalesce.join=fail")
        assert not plane.download(StubBackend(b"x"), None, job_dir, lambda u, p: None, url), (
            "a failed join must decline so the caller fetches directly")
    finally:
        pkg.failpoints.FAILPOINTS.reset()
        plane.registry.release_lease(lease)
        plane.store.close()


def test_failpoint_coalesce_lead_degrades_without_leaking_lease(pkg, tmp_path):
    plane = make_plane(pkg, tmp_path)
    url = "http://origin/lead-fail.bin"
    job_dir = str(tmp_path / "job-0")
    os.makedirs(job_dir)
    try:
        pkg.failpoints.FAILPOINTS.configure("coalesce.lead=fail")
        assert not plane.download(StubBackend(b"x"), None, job_dir, lambda u, p: None, url)
        pkg.failpoints.FAILPOINTS.reset()
        assert not plane.registry.is_leased(pkg.cas.content_key(url)), (
            "the failed election leaked its lease")
    finally:
        pkg.failpoints.FAILPOINTS.reset()
        plane.store.close()


def test_failpoint_schedules_pure_for_coalesce_sites(pkg):
    schedules = []
    for site in ("cas.lookup", "cas.put", "coalesce.join", "coalesce.lead"):
        pkg.failpoints.FAILPOINTS.configure(f"{site}=fail:0.5")
        try:
            first = pkg.failpoints.FAILPOINTS.schedule(site, 32)
            assert first == pkg.failpoints.FAILPOINTS.schedule(site, 32)
            schedules.append(first)
        finally:
            pkg.failpoints.FAILPOINTS.reset()
    # the other package draws the same decisions from the same seed
    other = PACKAGES[1] if pkg is PACKAGES[0] else PACKAGES[0]
    for site, first in zip(("cas.lookup", "cas.put", "coalesce.join", "coalesce.lead"),
                           schedules):
        other.failpoints.FAILPOINTS.configure(f"{site}=fail:0.5")
        try:
            assert other.failpoints.FAILPOINTS.schedule(site, 32) == first
        finally:
            other.failpoints.FAILPOINTS.reset()


def test_debug_snapshot_reflects_active_plane(pkg, tmp_path):
    singleflight = pkg.singleflight
    singleflight.activate(None)
    assert singleflight.debug_snapshot() == {"enabled": False}
    plane = make_plane(pkg, tmp_path)
    try:
        singleflight.activate(plane)
        snap = singleflight.debug_snapshot()
        assert snap["enabled"]
        assert snap["cas"]["root"] == plane.store.root
        assert snap["singleflight"]["leases"] == []
    finally:
        singleflight.activate(None)
        plane.store.close()


# -- the fleet walks --------------------------------------------------------------


def cache_env(pkg, broker, s3, base_dir, **extra):
    env = worker_env(
        pkg, broker, s3, base_dir, BUCKET=BUCKET, PREFETCH="1", WATCHDOG_STALL_S="600",
        MAX_JOB_RETRIES="50", RETRY_DELAY="0.3", RETRY_DELAY_CAP="1.0",
        S3_MULTIPART_THRESHOLD=str(256 * 1024), S3_PART_SIZE=str(256 * 1024),
        CACHE_DIR=os.path.join(base_dir, "shared-cache"), SINGLEFLIGHT_LEASE_S="2.0",
        SINGLEFLIGHT_WAIT_S="120",
    )
    env.update(extra)
    return env


def fleet_config(pkg, workers=2, **overrides):
    base = dict(workers=workers, heartbeat_s=0.2, stall_s=30.0, restart_backoff_s=0.1,
                restart_backoff_cap_s=0.5, start_grace_s=40.0, drain_s=10.0,
                scrape_timeout_s=2.0)
    base.update(overrides)
    return pkg.fleet.FleetConfig(**base)


def flash_crowd(pkg, body, tmp_path):
    with pkg.stub.S3Stub(pkg.creds) as s3, pkg.amqp_server.AmqpServerStub() as broker, \
            Origin({"/hot.mp4": body}, rate_bps=768 * 1024) as origin:
        supervisor = pkg.fleet.FleetSupervisor(
            fleet_config(pkg), worker_env=cache_env(pkg, broker, s3, str(tmp_path / pkg.name)))
        sink = health = None
        try:
            supervisor.start()
            wait(lambda: all(s["ready"] for s in supervisor.snapshot()["slots"]), 60.0,
                 "both real workers ready")
            sink = ConvertSink(pkg, broker)
            expected = {f"crowd-{index}" for index in range(6)}
            contexts = {media_id: publish_job(pkg, broker, media_id, f"{origin.url}/hot.mp4")
                        for media_id in sorted(expected)}
            wait(lambda: {e[0] for e in sink.snapshot()} >= expected, 120.0,
                 "the whole flash crowd to complete")
            assert all(contexts[m].trace_id == t for m, t in sink.snapshot())
            health = pkg.fleet.FleetHealthServer(supervisor, 0, "127.0.0.1").start()
            status, flows = http_get(health.port, "/debug/flows")
            assert status == 200
            status, cache = http_get(health.port, "/debug/cache")
            assert status == 200
            flows, instances = json.loads(flows), json.loads(cache)["instances"]
            return {
                "origin_gets": origin.data_gets(),
                "objects": stored(s3),
                "converts": sink.converts(origin.url),
                "flows": {k: flows[k] for k in ("workers", "unique_bytes", "ingress_bytes",
                                                "cache_hit_bytes", "origin_amplification")},
                "cache_instances": sorted(instances),
                "cache_enabled": all(entry["enabled"] for entry in instances.values()),
                "cache_has_entry": any(e["cas"]["entries"] >= 1 for e in instances.values()),
            }
        finally:
            if health is not None:
                health.stop()
            if sink is not None:
                sink.close()
            supervisor.drain()


def test_e2e_single_flight_flash_crowd_one_origin_fetch(tmp_path):
    """A flash crowd of SIX identical jobs against a throttled origin,
    drained by a real 2-worker fleet with the data plane on, costs ONE
    origin GET in either package; ``/debug/flows`` reports the same
    amplification, and ``/debug/cache`` the shared store from both
    instances."""
    body = payload(1536 * 1024, 20)
    port, ref = (flash_crowd(pkg, body, tmp_path) for pkg in PACKAGES)
    assert port == ref
    assert port["origin_gets"] == 1
    assert sorted(port["objects"].values()) == [body] * 6
    assert port["flows"] == {"workers": 2, "unique_bytes": len(body),
                             "ingress_bytes": len(body), "cache_hit_bytes": 5 * len(body),
                             "origin_amplification": port["flows"]["origin_amplification"]}
    assert port["flows"]["origin_amplification"] <= 1.2
    assert port["cache_instances"] == ["worker-0", "worker-1"]
    assert port["cache_enabled"] and port["cache_has_entry"]


def leader_kill(pkg, body, tmp_path):
    with pkg.stub.S3Stub(pkg.creds) as s3, pkg.amqp_server.AmqpServerStub() as broker, \
            Origin({"/hot.mp4": body}, rate_bps=1536 * 1024) as origin:
        supervisor = pkg.fleet.FleetSupervisor(
            fleet_config(pkg, stall_s=2.0),
            worker_env=cache_env(
                pkg, broker, s3, str(tmp_path / pkg.name),
                # dies on the 17th 256 KiB chunk write (~4 MB in); only an
                # elected leader writes, and the promoted successor resumes
                # the journal with fewer than 16 chunks left
                FAILPOINT_SPEC="segments.pwrite=kill:1:16", HTTP_SEGMENTS="2",
                HTTP_SEGMENT_MIN_MB="1", SINGLEFLIGHT_LEASE_S="1.0", WATCHDOG_STALL_S="60",
            ),
        )
        sink = health = None
        try:
            supervisor.start()
            wait(lambda: all(s["ready"] for s in supervisor.snapshot()["slots"]), 60.0,
                 "both real workers ready")
            sink = ConvertSink(pkg, broker)
            contexts = {f"chaos-{index}": publish_job(pkg, broker, f"chaos-{index}",
                                                      f"{origin.url}/hot.mp4")
                        for index in range(4)}
            wait(lambda: {e[0] for e in sink.snapshot()} >= set(contexts), 180.0,
                 "the crowd to complete through the leader's death")
            foreign = [e for e in sink.snapshot()
                       if e[0] in contexts and e[1] != contexts[e[0]].trace_id]
            assert not foreign, f"trace-id continuity broken: {foreign}"
            health = pkg.fleet.FleetHealthServer(supervisor, 0, "127.0.0.1").start()
            federated = wait(lambda: http_get(health.port, "/metrics/federate")[1], 30.0,
                             "the fleet exposition").decode()
            promotions = sum(float(line.rsplit(" ", 1)[1]) for line in federated.splitlines()
                             if line.startswith("downloader_singleflight_promotions_total"))
            wait(lambda: not s3.list_multipart_uploads(), 30.0,
                 "dangling multipart uploads to be reclaimed")
            return {
                "restarted": counter(pkg, "fleet_worker_restarts") >= 1,
                "promoted": promotions >= 1,
                "objects": stored(s3),
                "converts": sink.converts(origin.url),
                "dangling": s3.list_multipart_uploads(),
            }
        finally:
            if health is not None:
                health.stop()
            if sink is not None:
                sink.close()
            supervisor.drain()


def test_e2e_chaos_sigkill_coalesce_leader_promotes_follower(tmp_path):
    """The elected coalesce leader is SIGKILLed mid-fetch by a seeded
    failpoint in each package's fleet: its lease goes stale, a follower
    promotes itself and re-leads from the journaled spans, every job
    completes under its original trace id, the supervisor restarts the
    dead worker, and no multipart upload is left open. Both packages
    store the same objects and publish the same Converts."""
    body = payload(6 * 1024 * 1024, 21)
    port, ref = (leader_kill(pkg, body, tmp_path) for pkg in PACKAGES)
    assert port == ref
    assert port["restarted"] and port["promoted"]
    assert sorted(port["objects"].values()) == [body] * 4
    assert port["dangling"] == []


# -- the port's one-process serve() with the data plane --------------------------


@contextlib.contextmanager
def serving(tmp_path, monkeypatch, objects, rate_bps=0.0, **knobs):
    """The port's ``serve()`` in a thread over its AMQP and S3 stubs and
    a counting origin, with the data plane's knobs from ``knobs``."""
    stop_planes(PORT)
    token = PORT.cancel.CancelToken()
    health_port = free_port()
    with PORT.amqp_server.AmqpServerStub() as broker, PORT.stub.S3Stub(PORT.creds) as s3, \
            Origin(objects, rate_bps=rate_bps) as origin:
        monkeypatch.setenv("S3_ENDPOINT", f"http://{s3.endpoint}")
        monkeypatch.setenv("S3_ACCESS_KEY", PORT.creds.access_key)
        monkeypatch.setenv("S3_SECRET_KEY", PORT.creds.secret_key)
        monkeypatch.setenv("DHT_BOOTSTRAP", "off")
        monkeypatch.setenv("LSD", "off")
        config = PORT.config.Config.from_env({
            "BROKER": "amqp", "RABBITMQ_ENDPOINT": broker.endpoint, "RABBITMQ_USERNAME": "",
            "RABBITMQ_PASSWORD": "", "DOWNLOAD_DIR": str(tmp_path / "dl"), "BUCKET": BUCKET,
            "HEALTH_PORT": str(health_port), "CANARY": "off", "PROFILE": "0",
            "TSDB_INTERVAL": "0", "ALERT_INTERVAL": "0", "HTTP_SEGMENTS": "1",
            "BATCH_JOBS": "1", **knobs,
        })
        config.health_host = "127.0.0.1"
        before = set(threading.enumerate())
        served = threading.Thread(
            target=PORT.app.serve,
            kwargs=dict(config=config, token=token, install_signal_handlers=False),
            daemon=True,
        )
        served.start()
        sink = ConvertSink(PORT, broker)
        run = type("Run", (), dict(broker=broker, s3=s3, origin=origin, sink=sink,
                                   config=config, health_port=health_port))
        try:
            wait(lambda: served_ready(health_port), 30.0, "serve() to be ready")
            yield run
        finally:
            sink.close()
            token.cancel()
            served.join(timeout=20)
    assert not served.is_alive()
    leftover = lambda: [t.name for t in threading.enumerate() if t not in before and t.is_alive()]
    wait(lambda: not leftover(), 10.0, "every thread serve() started to stop")


def served_ready(port: int) -> bool:
    try:
        return http_get(port, "/readyz", timeout=2.0)[0] == 200
    except OSError:
        return False


def run_job(run, media_id: str, path: str, timeout: float = 30.0) -> float:
    """Publish one job and wait for its Convert; the seconds it took."""
    started = time.monotonic()
    publish_job(PORT, run.broker, media_id, f"{run.origin.url}{path}")
    wait(lambda: media_id in {e[0] for e in run.sink.snapshot()}, timeout,
         f"the Convert of {media_id}")
    return time.monotonic() - started


def test_serve_with_cache_dir_alone_serves_a_cache_hit(tmp_path, monkeypatch):
    """``CACHE_DIR`` without ``SINGLEFLIGHT_DIR`` in one process: the
    lease index goes under ``<CACHE_DIR>/inflight`` (the JAX package's
    serve() raises NameError here: its app.py calls ``os.path.join``
    without importing ``os``), and a second job for the same object is
    served from the cache."""
    body = payload(64 * 1024, 30)
    cache_dir = str(tmp_path / "cache")
    with serving(tmp_path, monkeypatch, {"/clip.mkv": body}, CACHE_DIR=cache_dir) as run:
        run_job(run, "first", "/clip.mkv")
        run_job(run, "second", "/clip.mkv")
        assert run.origin.data_gets() == 1
        snap = json.loads(http_get(run.health_port, "/debug/cache")[1])
        assert snap["enabled"] and snap["cas"]["hits"] >= 1 and snap["cas"]["entries"] == 1
        assert snap["singleflight"]["root"] == os.path.join(cache_dir, "inflight")
        assert sorted(stored(run.s3).values()) == [body, body]


def plant_lease(index_dir: str, url: str, age_s: float) -> str:
    """A lease of a foreign owner for ``url``'s content key, ``age_s``
    old by its heartbeat."""
    os.makedirs(index_dir, exist_ok=True)
    path = os.path.join(index_dir, PORT.cas.content_key(url) + ".lease")
    with open(path, "w") as sink:
        json.dump({"owner": "worker-elsewhere", "pid": 1, "nonce": "00", "url": url,
                   "created": time.time() - age_s}, sink)
    stamp = time.time() - age_s
    os.utime(path, (stamp, stamp))
    return path


KNOBS = ("CACHE_MAX_BYTES", "CACHE_TTL_S", "SINGLEFLIGHT_DIR", "SINGLEFLIGHT_LEASE_S",
         "SINGLEFLIGHT_WAIT_S", "FLEET_HEARTBEAT_S")


@pytest.mark.parametrize("knob", KNOBS)
def test_serve_reads_each_data_plane_knob(knob, tmp_path, monkeypatch):
    """Each knob ``Config.from_env`` parses for the data plane and the
    fleet heartbeat changes what the port's serve() does; at its default
    each test below would see the other outcome."""
    # four 64 KiB chunks: at 128 KiB/s the SINGLEFLIGHT_DIR case's fetch
    # holds its lease for about two seconds
    body = payload(256 * 1024, 31)
    cache_dir = str(tmp_path / "cache")
    knobs = {"CACHE_DIR": cache_dir}
    if knob == "CACHE_MAX_BYTES":
        knobs[knob] = "65536"  # smaller than the object: admission refused
    elif knob == "CACHE_TTL_S":
        knobs[knob] = "0.2"
    elif knob == "SINGLEFLIGHT_DIR":
        knobs[knob] = str(tmp_path / "index")
    elif knob == "SINGLEFLIGHT_LEASE_S":
        knobs[knob] = "1"
    elif knob == "SINGLEFLIGHT_WAIT_S":
        knobs[knob] = "0.3"
    else:
        knobs.update(FLEET_HEARTBEAT_FILE=str(tmp_path / "beat.json"), FLEET_HEARTBEAT_S="0.1")
    rate = 128 * 1024 if knob == "SINGLEFLIGHT_DIR" else 0.0
    with serving(tmp_path, monkeypatch, {"/clip.mkv": body}, rate_bps=rate, **knobs) as run:
        url = f"{run.origin.url}/clip.mkv"
        if knob in ("CACHE_MAX_BYTES", "CACHE_TTL_S"):
            run_job(run, "first", "/clip.mkv")
            time.sleep(0.5)  # past the 0.2 s TTL (the default is a day)
            run_job(run, "second", "/clip.mkv")
            # the default bound (2 GiB) and TTL would serve the second
            # job from the cache: one origin GET
            assert run.origin.data_gets() == 2
            if knob == "CACHE_MAX_BYTES":
                assert PORT.metrics.GLOBAL.snapshot().get("cache_admit_refusals_total", 0) >= 1
        elif knob == "SINGLEFLIGHT_DIR":
            # the lease of the running fetch lives in the given index,
            # not under <CACHE_DIR>/inflight
            publish_job(PORT, run.broker, "first", url)
            wait(lambda: [n for n in os.listdir(knobs[knob]) if n.endswith(".lease")], 10.0,
                 "the leader's lease in SINGLEFLIGHT_DIR")
            assert not os.path.exists(os.path.join(cache_dir, "inflight"))
            wait(lambda: "first" in {e[0] for e in run.sink.snapshot()}, 30.0, "the Convert")
        elif knob == "SINGLEFLIGHT_LEASE_S":
            # a lease 3 s stale: past a 1 s TTL the job promotes itself
            # at once; under the default 10 s it would follow the owner
            plant_lease(os.path.join(cache_dir, "inflight"), url, age_s=3.0)
            assert run_job(run, "first", "/clip.mkv") < 5.0
            assert PORT.metrics.GLOBAL.snapshot().get("singleflight_promotions_total") == 1
        elif knob == "SINGLEFLIGHT_WAIT_S":
            # a live foreign lease, kept fresh: the follower gives up
            # after 0.3 s and fetches itself (the default waits 120 s)
            lease = plant_lease(os.path.join(cache_dir, "inflight"), url, age_s=0.0)
            fresh = threading.Event()

            def keep_fresh():
                while not fresh.wait(0.1):
                    os.utime(lease)

            beater = threading.Thread(target=keep_fresh, daemon=True)
            beater.start()
            try:
                assert run_job(run, "first", "/clip.mkv") < 5.0
            finally:
                fresh.set()
                beater.join()
            snapshot = PORT.metrics.GLOBAL.snapshot()
            assert snapshot.get("singleflight_wait_timeouts_total") == 1
            assert snapshot.get("singleflight_promotions_total", 0) == 0
        else:
            # beats every 0.1 s: at the default 1 s, one second shows
            # at most two
            path = knobs["FLEET_HEARTBEAT_FILE"]
            stamps = set()
            deadline = time.monotonic() + 1.0
            while time.monotonic() < deadline:
                try:
                    with open(path) as source:
                        beat = json.load(source)
                    stamps.add(beat["ts"])
                except (OSError, ValueError):
                    pass
                time.sleep(0.02)
            assert len(stamps) >= 5, stamps
            assert beat["health_port"] == run.health_port
