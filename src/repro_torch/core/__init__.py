"""Byz-VR-MARINA core (port of ``repro.core``): the round engine, the MARINA
estimator, compressors, aggregators, attacks, the sparse wire and the
kernel aggregation backend."""
