"""Environment names the port reads (own copy of the subset of
``tony_tpu/constants.py`` it needs; the port imports nothing of tony_tpu)."""

# SIGTERM→SIGKILL window of the container (tony.task.kill-grace-ms): the
# server's drain budget is this window minus a teardown margin
ENV_KILL_GRACE_MS = "TONY_KILL_GRACE_MS"

# the executor's plumbing: which task this process is, of which job, and
# the job's staging directory (chaos latches and injection logs live there)
ENV_APP_ID = "TONY_APP_ID"
ENV_STAGING_DIR = "TONY_STAGING_DIR"
ENV_JOB_NAME = "JOB_NAME"                # task type, e.g. "worker"
ENV_TASK_INDEX = "TASK_INDEX"            # index within the type
ENV_RESTART_ATTEMPT = "TONY_RESTART_ATTEMPT"  # gang epoch (whole-gang restarts)

# training child: where the executor wants the latest step report, and the
# tony.checkpoint.* / tony.train.* keys of the frozen job conf
ENV_TRAIN_METRICS_FILE = "TONY_TRAIN_METRICS_FILE"
ENV_CHECKPOINT_DIR = "TONY_CHECKPOINT_DIR"            # from tony.checkpoint.dir
ENV_CHECKPOINT_INTERVAL = "TONY_CHECKPOINT_INTERVAL"  # from tony.checkpoint.interval-steps
ENV_PREFETCH_DEPTH = "TONY_PREFETCH_DEPTH"            # from tony.train.prefetch-depth
ENV_INPUT_WAIT_SPAN_MS = "TONY_INPUT_WAIT_SPAN_MS"    # from tony.train.input-wait-span-ms

# chaos (tony.chaos.spec / seed), tracing (tony.trace.*), structured logs
# (tony.log.*) and the metrics kill switch (tony.metrics.enabled), as the
# executor exports them to the training child
ENV_CHAOS_SPEC = "TONY_CHAOS_SPEC"
ENV_CHAOS_SEED = "TONY_CHAOS_SEED"
ENV_TRACE_ENABLED = "TONY_TRACE_ENABLED"  # "1" → tracing on in this process tree
ENV_TRACE_DIR = "TONY_TRACE_DIR"          # span JSONL sink dir (<staging>/trace)
ENV_TRACE_PARENT = "TONY_TRACE_PARENT"    # parent span id for this process's root span
ENV_LOG_DIR = "TONY_LOG_DIR"              # log JSONL sink dir (<staging>/logs)
ENV_LOG_LEVEL = "TONY_LOG_LEVEL"          # debug|info|warning|error|off
ENV_METRICS_ENABLED = "TONY_METRICS_ENABLED"  # "0" → metrics recording off

# profiling (tony.task.profile / tony.profile.*): the static window and how
# often the on-demand control file is polled
ENV_PROFILE_DIR = "TONY_PROFILE_DIR"
ENV_PROFILE_START_STEP = "TONY_PROFILE_START_STEP"
ENV_PROFILE_NUM_STEPS = "TONY_PROFILE_NUM_STEPS"
ENV_PROFILE_POLL_MS = "TONY_PROFILE_POLL_MS"

# gang size exported by the torch and JAX runtime adapters, and the
# torch.distributed rendezvous the torch adapter exports
ENV_WORLD_SIZE = "WORLD_SIZE"
ENV_JAX_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_RANK = "RANK"
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_MASTER_ADDR = "MASTER_ADDR"
ENV_MASTER_PORT = "MASTER_PORT"
ENV_INIT_METHOD = "INIT_METHOD"
