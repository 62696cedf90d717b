"""The scheduling side of the port: its own copy of the reference's
simulator core (performance model, interference, jobs and cluster,
Theorem 1, Algorithm 2, the event engine, ``SJF_BSBF``), the
calibration artifact, and the co-scheduling measurements on the device
(``core.coschedule``, which imports the executor and PyTorch)."""
