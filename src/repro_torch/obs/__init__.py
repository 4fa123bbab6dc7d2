"""The observability layer (port of ``repro.obs``).

* ``trace``   — ``RoundTrace``: per-round aggregator decisions (whom the
                rule picked, how much each worker weighed in the
                aggregate), built from the same backend calls that compute
                the aggregate, under ``RunSpec.trace``.
* ``detect``  — detection quality against the ground-truth byzantine mask
                (filter precision / recall, influence leakage), on the
                host.
* ``sink``    — the ``MetricSink`` event protocol (JSONL stream, in-memory
                ring, fan-out) and wall-clock spans.
* ``profile`` — a ``torch.profiler`` trace context and one range a round.
"""
from repro_torch.obs.detect import detection_metrics, filtered_mask, summarize
from repro_torch.obs.sink import (FanoutSink, JsonlSink, MetricSink, NullSink,
                                  RingSink, TagSink, span, verify_jsonl)
from repro_torch.obs.trace import (RoundTrace, to_host,
                                   traced_ingest_message_phase,
                                   traced_message_phase)

__all__ = [
    "RoundTrace", "traced_message_phase", "traced_ingest_message_phase",
    "to_host", "detection_metrics", "filtered_mask", "summarize",
    "MetricSink", "JsonlSink", "RingSink", "FanoutSink", "NullSink",
    "TagSink", "span", "verify_jsonl",
]
