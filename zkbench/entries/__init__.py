"""Drivers of the entries that a window calls, one module each (the
traffic file's `entry`).  A driver module holds `Driver` (set-up side
`prepare`, the timed `call`, `answers`, `units`, `work`) and `expected`,
the reference's answers for a request's inputs."""
