"""The port's side of the control plane's wire: its own copy of the RPC
client frame (``tony_tpu/cluster/rpc.py``) and of the executor's reachable
address rule, for the serving replica's registration with the AM."""
