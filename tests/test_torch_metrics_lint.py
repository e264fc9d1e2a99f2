"""Port twin of ``tests/test_metrics_lint.py``: the Prometheus
exposition lint of ``/metrics``.

The exposition format is a contract with the scraper: a family without
``# HELP``/``# TYPE``, a histogram whose cumulative buckets decrease or
whose ``+Inf`` count disagrees with ``_count``, or one family declared
twice are all silently mis-ingested (or dropped) by real Prometheus
servers rather than failing loudly. Each lint renders the real
``/metrics`` view (``daemon.health.HealthServer``) over a fully
populated registry, every bucket layout the code uses, and lints the
text the scraper would see: once over the port (``[port]``) and once
over the JAX package (``[ref]``), each with its own registry. Then the
port's families, types and help text must equal the reference's on the
same populated registry.
"""

import re
import types

import pytest

from downloader_tpu.daemon import health as ref_health
from downloader_tpu.utils import alerts as ref_alerts
from downloader_tpu.utils import flows as ref_flows
from downloader_tpu.utils import metrics as ref_metrics
from downloader_tpu_torch.daemon import health
from downloader_tpu_torch.utils import alerts, flows, metrics

PORT = types.SimpleNamespace(name="port", health=health, metrics=metrics, alerts=alerts,
                             flows=flows)
REF = types.SimpleNamespace(name="ref", health=ref_health, metrics=ref_metrics,
                            alerts=ref_alerts, flows=ref_flows)


@pytest.fixture(params=[PORT, REF], ids=["port", "ref"])
def pkg(request):
    return request.param


NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? ([^ ]+)$"
)


class _FakeDaemonStats:
    processed = 2
    failed = 1
    retried = 0
    dropped = 0
    shed = 0


class _FakeDaemon:
    stats = _FakeDaemonStats()
    worker_count = 3


class _FakeQueueStats:
    published = 5
    delivered = 6
    publish_retries = 0
    reconnects = 1
    consumer_errors = 0


class _FakeClient:
    stats = _FakeQueueStats()

    def connected(self):
        return True


@pytest.fixture
def exposition(pkg):
    """The /metrics body of ``pkg`` over a registry populated with
    every metric shape (counter, gauge, and one histogram per bucket
    layout)."""
    return _populated_exposition(pkg)


def _populated_exposition(pkg):
    metrics = pkg.metrics
    metrics.GLOBAL.reset()
    metrics.GLOBAL.add("http_files_fetched", 4)
    metrics.GLOBAL.add("watchdog_stalls", 1)
    metrics.GLOBAL.gauge_set("pipeline_parts_in_flight", 2)
    metrics.GLOBAL.gauge_set("watchdog_stalled_tasks", 1)
    # the per-kind multi-source families (fetch/sources.py): populate
    # every kind so the lint walks the real exposition each would get
    for kind in ("mirror", "webseed", "peer"):
        metrics.GLOBAL.gauge_set(f"fetch_sources_active_{kind}", 1)
        metrics.GLOBAL.add(f"source_bytes_total_{kind}", 1024)
        metrics.GLOBAL.add(f"source_demotions_total_{kind}", 1)
        metrics.GLOBAL.add(f"source_retires_total_{kind}", 1)
    metrics.GLOBAL.add("http_multi_source_fetches", 1)
    metrics.GLOBAL.add("http_source_failovers", 1)
    metrics.GLOBAL.add("http_mirror_rejects", 1)
    metrics.GLOBAL.observe("job_duration_seconds", 0.5)
    metrics.GLOBAL.observe(
        "overhead_seconds", 0.002, buckets=metrics.OVERHEAD_BUCKETS
    )
    metrics.GLOBAL.observe(
        "http_segments_per_fetch", 4, buckets=metrics.COUNT_BUCKETS
    )
    metrics.GLOBAL.observe(
        "pipeline_overlap_ratio", 0.7, buckets=metrics.RATIO_BUCKETS
    )
    metrics.GLOBAL.observe("pipeline_overlap_ratio", 1.5)  # over-bound tail
    # the profiling plane's families (utils/profiling.py): the
    # sampler's counters/gauge and one lock-wait histogram per named
    # lock, so the lint walks the real exposition each would get
    metrics.GLOBAL.add("profile_ticks", 3)
    metrics.GLOBAL.add("profile_samples", 30)
    metrics.GLOBAL.add("profile_heap_snapshots", 1)
    metrics.GLOBAL.gauge_set("profile_threads", 10)
    for lock_name in (
        "queue_client", "connpool", "pipeline_session",
        "segment_state", "probe_cache", "source_board",
    ):
        metrics.GLOBAL.observe(
            f"lock_wait_seconds_{lock_name}", 0.0005,
            buckets=metrics.LOCK_WAIT_BUCKETS,
        )
    # the flow-accounting plane's families (utils/flows.py): the byte
    # counters, the two alert-watched gauges, and one per-origin-host
    # counter exactly as fetch/sources.py emits it (name-encoded label,
    # derived HELP) so the lint walks the exposition a populated origin
    # dimension would get
    metrics.GLOBAL.add("flow_origin_bytes_total", 4096)
    metrics.GLOBAL.add("flow_unique_bytes_total", 2048)
    metrics.GLOBAL.add("flow_egress_bytes_total", 2048)
    metrics.GLOBAL.gauge_set("flow_origin_amplification", 2.0)
    metrics.GLOBAL.gauge_set("flow_hot_object_share", 0.5)
    metrics.GLOBAL.add("source_bytes_total_mirror_origin_cdn_example_com", 4096)
    # the fleet data plane's families (store/cas.py + fetch/
    # singleflight.py): cache counters/gauges, the coalescing
    # election counters, the follower-wait histogram, and the
    # cache-served flow lane
    metrics.GLOBAL.add("flow_cache_hit_bytes_total", 2048)
    metrics.GLOBAL.add("cache_hits_total", 2)
    metrics.GLOBAL.add("cache_misses_total", 1)
    metrics.GLOBAL.add("cache_hit_bytes_total", 2048)
    metrics.GLOBAL.add("cache_puts_total", 1)
    metrics.GLOBAL.add("cache_put_bytes_total", 1024)
    metrics.GLOBAL.add("cache_evictions_total", 1)
    metrics.GLOBAL.add("cache_corrupt_evictions_total", 1)
    metrics.GLOBAL.add("cache_admit_refusals_total", 1)
    metrics.GLOBAL.gauge_set("cache_entries", 1)
    metrics.GLOBAL.gauge_set("cache_bytes", 1024)
    metrics.GLOBAL.add("singleflight_leads_total", 1)
    metrics.GLOBAL.add("singleflight_joins_total", 2)
    metrics.GLOBAL.add("singleflight_promotions_total", 1)
    metrics.GLOBAL.add("singleflight_wait_timeouts_total", 1)
    metrics.GLOBAL.observe("singleflight_wait_seconds", 0.25)
    server = pkg.health.HealthServer(_FakeDaemon(), _FakeClient(), 0)
    try:
        code, body, ctype = server._metrics()
    finally:
        server._httpd.server_close()
    assert code == 200
    assert ctype.startswith("text/plain")
    metrics.GLOBAL.reset()
    return body.decode()


def _parse(text):
    """(families, samples): family -> {'help': str, 'type': str},
    sample name -> [(labels, value)]."""
    families: dict[str, dict] = {}
    samples: dict[str, list] = {}
    declared_order: dict[str, int] = {}
    for lineno, line in enumerate(text.splitlines()):
        assert line.strip() == line and line, f"ragged line {lineno}: {line!r}"
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            assert NAME_RE.fullmatch(name), f"bad HELP name: {line!r}"
            assert help_text.strip(), f"empty HELP text: {line!r}"
            assert name not in families, f"duplicate HELP for {name}"
            families[name] = {"help": help_text, "type": None}
            declared_order[name] = lineno
        elif line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, kind = rest.partition(" ")
            assert kind in ("counter", "gauge", "histogram"), (
                f"bad TYPE: {line!r}"
            )
            assert name in families, f"TYPE before HELP for {name}"
            assert families[name]["type"] is None, f"duplicate TYPE for {name}"
            families[name]["type"] = kind
        elif line.startswith("#"):
            raise AssertionError(f"unknown comment line: {line!r}")
        else:
            match = SAMPLE_RE.match(line)
            assert match, f"unparseable sample line: {line!r}"
            name, labels, value = match.groups()
            float(value)  # must parse
            samples.setdefault(name, []).append((labels or "", float(value)))
    return families, samples


def _family_of(sample_name, families):
    for suffix in ("_bucket", "_sum", "_count"):
        if sample_name.endswith(suffix):
            base = sample_name[: -len(suffix)]
            if base in families and families[base]["type"] == "histogram":
                return base
    return sample_name


def test_every_family_has_help_and_type(pkg, exposition):
    families, samples = _parse(exposition)
    for sample_name in samples:
        family = _family_of(sample_name, families)
        assert family in families, f"sample {sample_name} has no family"
        meta = families[family]
        assert meta["type"] is not None, f"{family} missing # TYPE"
        assert meta["help"].strip(), f"{family} missing # HELP"
    # and no family is declared without samples
    for family in families:
        owned = [
            s for s in samples if _family_of(s, families) == family
        ]
        assert owned, f"family {family} declared but has no samples"


def test_no_duplicate_families(pkg, exposition):
    # _parse asserts duplicate HELP/TYPE; also assert no sample name
    # appears under two declarations (counter vs gauge collision)
    families, samples = _parse(exposition)
    seen = {}
    for sample_name, entries in samples.items():
        family = _family_of(sample_name, families)
        kind = families[family]["type"]
        if kind != "histogram":
            assert len(entries) == 1, (
                f"{sample_name} sampled {len(entries)} times"
            )
        previous = seen.setdefault(sample_name, family)
        assert previous == family


def test_histogram_triples_consistent(pkg, exposition):
    families, samples = _parse(exposition)
    histograms = [
        name for name, meta in families.items()
        if meta["type"] == "histogram"
    ]
    assert histograms, "no histogram families rendered"
    for name in histograms:
        buckets = samples.get(f"{name}_bucket", [])
        assert buckets, f"{name}: no _bucket samples"
        les = []
        for labels, value in buckets:
            match = re.fullmatch(r'\{le="([^"]+)"\}', labels)
            assert match, f"{name}: bucket without le label: {labels!r}"
            les.append((match.group(1), value))
        assert les[-1][0] == "+Inf", f"{name}: buckets must end at +Inf"
        bounds = [float(le) for le, _ in les[:-1]]
        assert bounds == sorted(bounds), f"{name}: le bounds out of order"
        counts = [value for _, value in les]
        assert counts == sorted(counts), (
            f"{name}: cumulative bucket counts decrease: {counts}"
        )
        (sum_labels, total), = samples.get(f"{name}_sum", [("", None)])
        (count_labels, count), = samples.get(f"{name}_count", [("", None)])
        assert total is not None, f"{name}: missing _sum"
        assert count is not None, f"{name}: missing _count"
        assert sum_labels == "" and count_labels == ""
        assert counts[-1] == count, (
            f"{name}: +Inf bucket {counts[-1]} != _count {count}"
        )
        # an observation above the top finite bound must still land in
        # +Inf/_count (the over-bound tail observed in the fixture)
        assert count >= counts[-2] if len(counts) > 1 else True


def test_source_families_carry_catalogued_help(pkg, exposition):
    """Every per-kind multi-source family must have a CATALOGUED HELP
    line (metrics.HELP), not the derived word-swap fallback — these are
    the series the multi-source dashboards key on."""
    HELP = pkg.metrics.HELP

    families, _ = _parse(exposition)
    for kind in ("mirror", "webseed", "peer"):
        for stem in (
            "fetch_sources_active",
            "source_bytes_total",
            "source_demotions_total",
            "source_retires_total",
        ):
            name = f"{stem}_{kind}"
            assert name in HELP, f"{name} missing from the HELP catalog"
            exported = f"downloader_{name}"
            assert exported in families, f"{exported} not exported"
            assert families[exported]["help"] == HELP[name]
    for name in (
        "http_multi_source_fetches",
        "http_source_failovers",
        "http_mirror_rejects",
    ):
        assert name in HELP, f"{name} missing from the HELP catalog"


def test_profiling_families_carry_catalogued_help(pkg, exposition):
    """Every lock-wait histogram and profiler family must have a
    CATALOGUED HELP line (metrics.HELP), not the derived word-swap
    fallback — the contention dashboards key on these, and the lock
    names ARE the guarded-by identities."""
    HELP = pkg.metrics.HELP

    families, _ = _parse(exposition)
    for lock_name in (
        "queue_client", "connpool", "pipeline_session",
        "segment_state", "probe_cache", "source_board",
    ):
        name = f"lock_wait_seconds_{lock_name}"
        assert name in HELP, f"{name} missing from the HELP catalog"
        exported = f"downloader_{name}"
        assert exported in families, f"{exported} not exported"
        assert families[exported]["type"] == "histogram"
        assert families[exported]["help"] == HELP[name]
    for name in (
        "profile_ticks", "profile_samples", "profile_threads",
        "profile_heap_snapshots",
    ):
        assert name in HELP, f"{name} missing from the HELP catalog"


def test_flow_families_carry_catalogued_help(pkg, exposition):
    """Every flow-accounting family must have a CATALOGUED HELP line
    (metrics.HELP) — the amplification/hot-share gauges are watched by
    stock alert rules, so a missing catalog entry would trip the rule
    lint below. The per-origin-host counters are the one sanctioned
    derived-HELP family: their names are minted at runtime from a
    BOUNDED label registry (flows.origin_label), so the catalog cannot
    enumerate them — the lint asserts they still render well-formed."""
    HELP = pkg.metrics.HELP

    families, _ = _parse(exposition)
    for name in (
        "flow_origin_bytes_total",
        "flow_unique_bytes_total",
        "flow_egress_bytes_total",
        "flow_origin_amplification",
        "flow_hot_object_share",
    ):
        assert name in HELP, f"{name} missing from the HELP catalog"
        exported = f"downloader_{name}"
        assert exported in families, f"{exported} not exported"
        assert families[exported]["help"] == HELP[name]
    per_origin = "downloader_source_bytes_total_mirror_origin_cdn_example_com"
    assert per_origin in families, "per-origin counter not exported"
    assert families[per_origin]["type"] == "counter"
    assert families[per_origin]["help"].strip()


def test_cache_families_carry_catalogued_help(pkg, exposition):
    """Every fleet-data-plane family — the content-addressed cache's
    counters and gauges, the single-flight election counters, the
    follower-wait histogram, and the cache-served flow lane — must
    carry a CATALOGUED HELP line (metrics.HELP), not the derived
    fallback; these are the series the bench digest and the CI
    single-flight smoke read."""
    HELP = pkg.metrics.HELP

    families, _ = _parse(exposition)
    for name in (
        "flow_cache_hit_bytes_total",
        "cache_hits_total",
        "cache_misses_total",
        "cache_hit_bytes_total",
        "cache_puts_total",
        "cache_put_bytes_total",
        "cache_evictions_total",
        "cache_corrupt_evictions_total",
        "cache_admit_refusals_total",
        "cache_entries",
        "cache_bytes",
        "singleflight_leads_total",
        "singleflight_joins_total",
        "singleflight_promotions_total",
        "singleflight_wait_timeouts_total",
        "singleflight_wait_seconds",
    ):
        assert name in HELP, f"{name} missing from the HELP catalog"
        exported = f"downloader_{name}"
        assert exported in families, f"{exported} not exported"
        assert families[exported]["help"] == HELP[name]
    assert families["downloader_singleflight_wait_seconds"]["type"] == (
        "histogram"
    )
    for gauge in ("downloader_cache_entries", "downloader_cache_bytes"):
        assert families[gauge]["type"] == "gauge"


def test_flow_alert_rules_in_stock_set(pkg):
    """The two flow rules ride in alerts.default_rules() (the generic
    rule lint in test_alert_rules_reference_registered_families then
    holds them to the catalog): amplification burn is page-severity
    with a sustain window, concentration is a ticket."""
    alerts, flows = pkg.alerts, pkg.flows

    rules = {rule.name: rule for rule in alerts.default_rules()}
    burn = rules["origin-amplification-burn"]
    assert burn.series == "flow_origin_amplification"
    assert burn.threshold == flows.amplification_alert_from_env()
    assert burn.for_s == alerts.AMPLIFICATION_BURN_FOR_S
    hot = rules["hot-object-concentration"]
    assert hot.series == "flow_hot_object_share"
    assert hot.severity == "ticket"


def test_alert_rules_reference_registered_families(pkg, exposition):
    """The alert-catalog lint : every rule in the
    stock alert set must reference a metric family that actually
    exists — catalogued in metrics.HELP, and (for the burn rules) a
    histogram the exposition seeds from the first scrape, so an alert
    can never silently watch a series nobody emits."""
    alerts, metrics = pkg.alerts, pkg.metrics

    families, _ = _parse(exposition)
    rules = alerts.default_rules()
    assert rules, "stock alert rule set is empty"
    seen_names = set()
    for rule in rules:
        assert rule.name not in seen_names, f"duplicate rule {rule.name}"
        seen_names.add(rule.name)
        assert rule.series in metrics.HELP, (
            f"alert rule '{rule.name}' references series "
            f"'{rule.series}' missing from the HELP catalog"
        )
        if isinstance(rule, alerts.BurnRateRule):
            exported = f"downloader_{rule.series}"
            assert exported in families, (
                f"burn rule '{rule.name}' series {exported} not "
                "seeded in the exposition"
            )
            assert families[exported]["type"] == "histogram", (
                f"burn rule '{rule.name}' must watch a histogram"
            )


def test_expected_series_present(pkg, exposition):
    """The families the dashboards/alerts reference exist in one scrape
    of a populated registry."""
    for needle in (
        "downloader_jobs_processed",
        "downloader_broker_connected",
        "downloader_watchdog_stalls",
        "downloader_watchdog_stalled_tasks",
        "downloader_job_duration_seconds_bucket",
        "downloader_overhead_seconds_count",
        "downloader_pipeline_overlap_ratio_sum",
    ):
        assert re.search(
            rf"^{re.escape(needle)}[ {{]", exposition, re.M
        ), f"missing series {needle}"


def test_port_families_equal_the_references():
    """The same populated registry renders the same families, with the
    same types and help text, from both packages; the sample names and
    bucket bounds agree too."""
    port_families, port_samples = _parse(_populated_exposition(PORT))
    ref_families, ref_samples = _parse(_populated_exposition(REF))
    assert port_families == ref_families
    assert len(port_families) > 50
    assert {name: [labels for labels, _ in rows] for name, rows in port_samples.items()} == {
        name: [labels for labels, _ in rows] for name, rows in ref_samples.items()}
    assert metrics.HELP == ref_metrics.HELP
    assert [(rule.name, rule.series, type(rule).__name__) for rule in alerts.default_rules()] == [
        (rule.name, rule.series, type(rule).__name__) for rule in ref_alerts.default_rules()]
