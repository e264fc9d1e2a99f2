"""Daemon configuration from environment variables.

Mirrors the reference's env contract (SURVEY.md §5 "Config"):

- ``RABBITMQ_ENDPOINT`` default ``127.0.0.1:5672`` with a warning
  (cmd/downloader/downloader.go:54-58); ``RABBITMQ_USERNAME`` /
  ``RABBITMQ_PASSWORD`` (client.go:308),
- ``LOG_LEVEL`` / ``LOG_FORMAT`` handled by utils.logging,
- S3 config handled by store.credentials / store.uploader,
- hardcoded-in-the-reference values surfaced as env with the reference
  values as defaults: topics ``v1.download``/``v1.convert`` (cmd:68,147),
  bucket ``triton-staging`` (cmd:95), prefetch 1 (cmd:62), download dir
  ``./downloading`` (cmd:86).

Additions over the reference: ``BROKER`` selects the transport (``amqp``
or ``memory`` for hermetic/standalone runs) and ``JOB_CONCURRENCY`` lifts
the hardwired single job goroutine (reference TODO cmd:100-101).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Mapping

from ..utils import get_logger

log = get_logger("daemon")


@dataclass
class Config:
    broker: str = "amqp"
    amqp_endpoint: str = "127.0.0.1:5672"
    amqp_username: str = ""
    amqp_password: str = ""
    consume_topic: str = "v1.download"
    publish_topic: str = "v1.convert"
    bucket: str = "triton-staging"
    base_dir: str = field(
        default_factory=lambda: os.path.join(os.getcwd(), "downloading")
    )
    prefetch: int = 1
    concurrency: int = 1
    max_job_retries: int = 3
    retry_delay: float = 10.0  # reference delivery.go:75
    # cap on the full-jitter retry backoff window: attempt n of a
    # transient settle waits uniform[0, min(cap, retry_delay * 2^(n-1)))
    retry_delay_cap: float = 60.0
    publish_confirm_timeout: float = 30.0  # Convert hand-off confirmation
    health_port: int = 0  # 0 = disabled
    health_host: str = "127.0.0.1"  # bind loopback unless told otherwise
    trace: bool = True  # per-job span tracing (TRACE=off disables)
    trace_ring: int = 64  # completed span trees kept for /debug/jobs
    # telemetry plane (utils/{tracing,tsdb,alerts}.py): trace-context
    # propagation across queue hops, the local time-series store the
    # burn-rate rules evaluate over, and the alert engine's cadence +
    # SLO parameters. instance is this worker's label in federated
    # scrapes (/metrics/federate).
    trace_propagate: bool = True
    tsdb_interval: float = 10.0
    tsdb_samples: int = 360
    tsdb_downsample: int = 10
    alert_interval: float = 15.0
    alert_fast_window: float = 300.0
    alert_slow_window: float = 3600.0
    alert_burn_factor: float = 14.4
    alert_objective: float = 0.99
    alert_slo_interactive_s: float = 1.0
    alert_slo_bulk_s: float = 60.0
    instance: str = ""
    # continuous profiling plane (utils/profiling.py): thread-role-
    # attributed stack sampling + named-lock wait timing (always on,
    # fixed overhead) and opt-in tracemalloc heap snapshots
    profile: bool = True
    profile_interval_ms: float = 50.0
    profile_ring: int = 16384
    profile_heap_s: float = 0.0
    profile_heap_top: int = 20
    profile_heap_frames: int = 5
    # segmented HTTP fetch (fetch/segments.py): max concurrent ranges
    # per object (1 = single-stream only) and the per-host keep-alive
    # pool bounds (fetch/connpool.py)
    http_segments: int = 8
    http_pool_per_host: int = 6
    http_pool_idle: float = 30.0
    # multi-source racing fetch (fetch/sources.py): fallback mirror
    # list applied to every job (merged with the job's X-Mirrors
    # header), capped at mirror_max. The per-source demotion/
    # retirement knobs (SOURCE_DEMOTE_RATIO, SOURCE_RETIRE_ERRORS) are
    # read by the fetcher itself, like ZEROCOPY.
    mirror_urls: "tuple[str, ...]" = ()
    mirror_max: int = 4
    # batched small-object fast path (daemon/app.py): one dequeue wave
    # drains up to batch_jobs already-waiting deliveries (lingering at
    # most batch_wait_ms once a burst is in progress — a lone job never
    # waits); jobs whose probed size is at most batch_max_bytes run the
    # batched lane (pooled single-connection fetch, per-batch store
    # connection, one coalesced confirm wait, multiple-ack settle).
    # batch_jobs <= 1 disables batching entirely.
    batch_jobs: int = 16
    batch_wait_ms: float = 20.0
    batch_max_bytes: int = 4 * 1024 * 1024
    # stall watchdog + incident flight recorder (utils/watchdog.py,
    # utils/incident.py): no-forward-progress deadline (0 disables),
    # per-stage overrides, what to do about a stall, and where bundles
    # persist / how many are retained
    watchdog_stall_s: float = 120.0
    watchdog_action: str = "log"
    watchdog_stages: "dict[str, float]" = field(default_factory=dict)
    incident_dir: str = ""
    incident_keep: int = 16
    # SLO-aware admission (utils/admission.py): class/tenant headers,
    # weighted-fair dequeue, per-tenant quotas, resource budgets, the
    # degradation ladder, and the DLQ shed contract
    admission_default_class: str = "bulk"
    admission_budgets: "dict[str, int]" = field(default_factory=dict)
    admission_weights: "dict[str, int]" = field(default_factory=dict)
    admission_shrink_at: float = 0.75
    admission_pause_at: float = 0.90
    admission_shed_at: float = 1.0
    admission_min_prefetch: int = 1
    quota_tenant_jobs: int = 0  # 0 = unlimited
    quota_tenant_bytes: int = 0  # 0 = unlimited
    dlq_queue: str = ""  # empty: <consume_topic>.dlq
    dlq_max_redeliver: int = 3
    dlq_retry_after_base: float = 5.0
    dlq_retry_after_cap: float = 300.0
    # crash-only fleet (daemon/fleet.py): when the supervisor spawned
    # this process it hands down the heartbeat-file path and cadence;
    # serve() then runs a HeartbeatWriter thread feeding the parent's
    # liveness verdicts. Empty = not a fleet member, no thread.
    fleet_heartbeat_file: str = ""
    fleet_heartbeat_s: float = 1.0
    # fleet data plane (store/cas.py + fetch/singleflight.py): the
    # shared content-addressed cache + single-flight election both
    # fetch lanes front when cache_dir is set. Empty = disabled, every
    # fetch goes to origin (the pre-data-plane behavior).
    cache_dir: str = ""
    cache_max_bytes: int = 2 * 1024**3
    cache_ttl_s: float = 24 * 3600.0
    singleflight_dir: str = ""  # empty derives <cache_dir>/inflight
    singleflight_lease_s: float = 10.0
    singleflight_wait_s: float = 120.0
    # synthetic canary plane (utils/canary.py): active probe jobs with
    # known content through the real pipeline, verified outside-in.
    # CANARY=0 builds no prober, no origin, no hooks.
    canary: bool = True
    canary_interval_s: float = 60.0
    canary_timeout_s: float = 30.0
    canary_history: int = 32
    canary_object_bytes: int = 64 * 1024

    @property
    def dead_letter_queue(self) -> str:
        from ..queue.delivery import dlq_name

        return self.dlq_queue or dlq_name(self.consume_topic)

    @classmethod
    def from_env(cls, environ: Mapping[str, str] | None = None) -> "Config":
        env = os.environ if environ is None else environ
        config = cls()
        config.broker = env.get("BROKER", config.broker).lower()
        endpoint = env.get("RABBITMQ_ENDPOINT", "")
        if endpoint:
            config.amqp_endpoint = endpoint
        elif config.broker == "amqp":
            log.warning(
                "RABBITMQ_ENDPOINT not defined, defaulting to local config: "
                f"{config.amqp_endpoint}"
            )
        config.amqp_username = env.get("RABBITMQ_USERNAME", "")
        config.amqp_password = env.get("RABBITMQ_PASSWORD", "")
        config.consume_topic = env.get("CONSUME_TOPIC", config.consume_topic)
        config.publish_topic = env.get("PUBLISH_TOPIC", config.publish_topic)
        config.bucket = env.get("BUCKET", config.bucket)
        config.base_dir = env.get("DOWNLOAD_DIR", config.base_dir)
        config.prefetch = int(env.get("PREFETCH", config.prefetch))
        config.concurrency = int(env.get("JOB_CONCURRENCY", config.concurrency))
        config.max_job_retries = int(
            env.get("MAX_JOB_RETRIES", config.max_job_retries)
        )
        config.retry_delay = float(env.get("RETRY_DELAY", config.retry_delay))
        config.retry_delay_cap = float(
            env.get("RETRY_DELAY_CAP", config.retry_delay_cap)
        )
        config.publish_confirm_timeout = float(
            env.get("PUBLISH_CONFIRM_TIMEOUT", config.publish_confirm_timeout)
        )
        config.health_port = int(env.get("HEALTH_PORT", config.health_port))
        config.health_host = env.get("HEALTH_HOST", config.health_host)
        config.batch_jobs = int(env.get("BATCH_JOBS", config.batch_jobs))
        config.batch_wait_ms = float(
            env.get("BATCH_WAIT_MS", config.batch_wait_ms)
        )
        config.batch_max_bytes = int(
            env.get("BATCH_MAX_BYTES", config.batch_max_bytes)
        )
        from ..utils import flag_from_env
        from ..utils.tracing import ring_from_value

        config.trace = flag_from_env("TRACE", env)
        config.trace_ring = ring_from_value(
            env.get("TRACE_RING"), config.trace_ring
        )
        from ..utils import alerts, metrics, tsdb
        from ..utils.tracing import propagate_from_env

        config.trace_propagate = propagate_from_env(env)
        config.tsdb_interval = tsdb.interval_from_env(env)
        config.tsdb_samples = tsdb.samples_from_env(env)
        config.tsdb_downsample = tsdb.downsample_from_env(env)
        config.alert_interval = alerts.interval_from_env(env)
        config.alert_fast_window, config.alert_slow_window = (
            alerts.windows_from_env(env)
        )
        config.alert_burn_factor = alerts.burn_factor_from_env(env)
        config.alert_objective = alerts.objective_from_env(env)
        (
            config.alert_slo_interactive_s,
            config.alert_slo_bulk_s,
        ) = alerts.slo_targets_from_env(env)
        config.instance = metrics.instance_from_env(env)
        from ..utils import profiling

        config.profile = profiling.enabled_from_env(env)
        config.profile_interval_ms = profiling.interval_from_env(env)
        config.profile_ring = profiling.ring_from_env(env)
        config.profile_heap_s = profiling.heap_interval_from_env(env)
        config.profile_heap_top = profiling.heap_top_from_env(env)
        config.profile_heap_frames = profiling.heap_frames_from_env(env)
        from ..fetch.connpool import (
            pool_idle_from_env,
            pool_per_host_from_env,
        )
        from ..fetch.segments import segments_from_env

        config.http_segments = segments_from_env(env)
        config.http_pool_per_host = pool_per_host_from_env(env)
        config.http_pool_idle = pool_idle_from_env(env)
        from ..fetch import sources

        config.mirror_urls = sources.mirrors_from_env(env)
        config.mirror_max = sources.mirror_max_from_env(env)
        from ..utils import incident, watchdog

        config.watchdog_stall_s = watchdog.stall_from_env(env)
        config.watchdog_action = watchdog.action_from_env(env)
        config.watchdog_stages = watchdog.stage_overrides_from_env(env)
        config.incident_dir = incident.dir_from_env(env)
        config.incident_keep = incident.keep_from_env(env)
        from ..utils import admission

        config.admission_default_class = admission.default_class_from_env(env)
        config.admission_budgets = admission.budgets_from_env(env)
        config.admission_weights = admission.class_weights_from_env(env)
        (
            config.admission_shrink_at,
            config.admission_pause_at,
            config.admission_shed_at,
        ) = admission.ladder_from_env(env)
        config.admission_min_prefetch = admission.min_prefetch_from_env(env)
        config.quota_tenant_jobs, config.quota_tenant_bytes = (
            admission.quotas_from_env(env)
        )
        config.dlq_queue = env.get("DLQ_QUEUE", config.dlq_queue).strip()
        config.dlq_max_redeliver = int(
            env.get("DLQ_MAX_REDELIVER", config.dlq_max_redeliver)
        )
        config.dlq_retry_after_base = float(
            env.get("DLQ_RETRY_AFTER_BASE", config.dlq_retry_after_base)
        )
        config.dlq_retry_after_cap = float(
            env.get("DLQ_RETRY_AFTER_CAP", config.dlq_retry_after_cap)
        )
        from .fleet import heartbeat_from_env

        config.fleet_heartbeat_file = (
            env.get("FLEET_HEARTBEAT_FILE") or ""
        ).strip()
        config.fleet_heartbeat_s = heartbeat_from_env(env)
        from ..fetch import singleflight
        from ..store import cas

        config.cache_dir = cas.dir_from_env(env)
        config.cache_max_bytes = cas.max_bytes_from_env(env)
        config.cache_ttl_s = cas.ttl_from_env(env)
        config.singleflight_dir = singleflight.inflight_dir_from_env(env)
        config.singleflight_lease_s = singleflight.lease_ttl_from_env(env)
        config.singleflight_wait_s = singleflight.wait_from_env(env)
        from ..utils import canary

        config.canary = canary.enabled_from_env(env)
        config.canary_interval_s = canary.interval_from_env(env)
        config.canary_timeout_s = canary.timeout_from_env(env)
        config.canary_history = canary.history_from_env(env)
        config.canary_object_bytes = canary.object_bytes_from_env(env)
        return config
