"""Row bands over several devices: device selection and per-device dispatch
(``devices.py``), the static band split (``sharding.py``) and the tuned one
(``hetero.py``)."""
