"""Environment names the port's server reads (own copy of the subset of
``tony_tpu/constants.py`` it needs; the port imports nothing of tony_tpu)."""

# SIGTERM→SIGKILL window of the container (tony.task.kill-grace-ms): the
# server's drain budget is this window minus a teardown margin
ENV_KILL_GRACE_MS = "TONY_KILL_GRACE_MS"
