"""Buffered-asynchronous Byzantine-robust aggregation service (port of
``repro.serve``).

The streaming workload over the unchanged kernels: seeded arrival
processes with chaos injection (``arrivals``), a double-buffered update
buffer on the device with sequence dedup (``buffer``), and the
FedBuff-style round engine that staleness-weights and robustly aggregates
whatever the buffer holds (``service``).

    from repro_torch.api import ServeSpec
    result = ServeSpec(method="sgd", aggregator="cm", n_clients=32,
                       n_byz=4, buffer_size=8, rounds=50,
                       agg_mode="pallas").run()

``run()`` takes the card; ``run(device="cpu")`` the plain PyTorch path.
"""
from repro_torch.serve.arrivals import (  # noqa: F401
    Arrival, ArrivalProcess, make_arrivals,
)
from repro_torch.serve.buffer import DoubleBuffer  # noqa: F401
from repro_torch.serve.service import (  # noqa: F401
    AggregationService, ServeResult, params_digest, staleness_weights,
)
