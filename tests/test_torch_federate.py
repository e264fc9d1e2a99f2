"""The port's ``/metrics/federate`` against the JAX package's.

Mirrors ``tests/test_federate.py`` over both packages: a stub child
worker registers its exposition as a federation source, a real HTTP
scrape hits each package's ``/metrics/federate``, and the scraper-side
parser recovers every sample, parent and child, keyed by its
``instance`` label, with each family's metadata declared once. Both
packages must serve the same samples.
"""

import urllib.request

import pytest

from test_federate import CHILD_EXPOSITION, _FakeClient, _FakeDaemon, scrape_side_parse
from test_torch_fleet import PACKAGE_IDS, PACKAGES


@pytest.fixture(params=PACKAGES, ids=PACKAGE_IDS)
def pkg(request):
    return request.param


def serve_health(pkg):
    pkg.metrics.GLOBAL.reset()
    pkg.metrics.FEDERATION.reset()
    pkg.metrics.FEDERATION.instance = "parent-0"
    return pkg.health.HealthServer(_FakeDaemon(), _FakeClient(), 0).start()


def scrape(health) -> str:
    url = f"http://127.0.0.1:{health.port}/metrics/federate"
    return urllib.request.urlopen(url, timeout=5).read().decode()


@pytest.fixture
def server(pkg):
    health = serve_health(pkg)
    yield health
    health.stop()
    pkg.metrics.FEDERATION.reset()
    pkg.metrics.GLOBAL.reset()


def test_child_source_round_trips_through_the_scraper(pkg, server):
    pkg.metrics.FEDERATION.register_source("child-1", lambda: CHILD_EXPOSITION)
    samples, declared = scrape_side_parse(scrape(server))
    assert samples[("downloader_jobs_processed", "child-1")] == 41.0
    assert samples[("downloader_child_only_total", "child-1")] == 5.0
    assert samples[("downloader_admission_pressure", "child-1")] == 0.25
    assert samples[("downloader_jobs_processed", "parent-0")] == 7.0
    for key, count in declared.items():
        assert count == 1, f"{key} declared {count} times"
    assert pkg.metrics.GLOBAL.snapshot().get("federate_scrapes", 0) >= 1
    # the other package serves the same child samples
    other = PACKAGES[1] if pkg is PACKAGES[0] else PACKAGES[0]
    health = serve_health(other)
    try:
        other.metrics.FEDERATION.register_source("child-1", lambda: CHILD_EXPOSITION)
        theirs, _ = scrape_side_parse(scrape(health))
    finally:
        health.stop()
        other.metrics.FEDERATION.reset()
        other.metrics.GLOBAL.reset()
    child = {key: value for key, value in samples.items() if key[1] == "child-1"}
    assert child == {key: value for key, value in theirs.items() if key[1] == "child-1"}


def test_failing_child_source_costs_its_samples_not_the_scrape(pkg, server):
    pkg.metrics.FEDERATION.register_source("child-ok", lambda: CHILD_EXPOSITION)

    def broken():
        raise ConnectionError("child worker down")

    pkg.metrics.FEDERATION.register_source("child-down", broken)
    samples, _ = scrape_side_parse(scrape(server))
    assert samples[("downloader_child_only_total", "child-ok")] == 5.0
    assert not any(inst == "child-down" for _, inst in samples)
    assert pkg.metrics.GLOBAL.snapshot().get("federate_source_errors") == 1


def test_unregistered_source_disappears(pkg, server):
    pkg.metrics.FEDERATION.register_source("child-1", lambda: CHILD_EXPOSITION)
    pkg.metrics.FEDERATION.unregister_source("child-1")
    samples, _ = scrape_side_parse(scrape(server))
    assert not any(inst == "child-1" for _, inst in samples)
