"""Environment names the port reads (own copy of the subset of
``tony_tpu/constants.py`` it needs; the port imports nothing of tony_tpu)."""

# SIGTERM→SIGKILL window of the container (tony.task.kill-grace-ms): the
# server's drain budget is this window minus a teardown margin
ENV_KILL_GRACE_MS = "TONY_KILL_GRACE_MS"

# training child: where the executor wants the latest step report, and the
# tony.checkpoint.* / tony.train.* keys of the frozen job conf
ENV_TRAIN_METRICS_FILE = "TONY_TRAIN_METRICS_FILE"
ENV_CHECKPOINT_DIR = "TONY_CHECKPOINT_DIR"            # from tony.checkpoint.dir
ENV_CHECKPOINT_INTERVAL = "TONY_CHECKPOINT_INTERVAL"  # from tony.checkpoint.interval-steps
ENV_PREFETCH_DEPTH = "TONY_PREFETCH_DEPTH"            # from tony.train.prefetch-depth

# gang size exported by the torch and JAX runtime adapters
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
