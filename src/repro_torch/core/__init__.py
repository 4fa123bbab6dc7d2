"""Byz-VR-MARINA core (port of ``repro.core``): the round engine, the
estimators of every method and the baselines' makers, compressors,
aggregators, attacks, the wire and the kernel aggregation backend."""
