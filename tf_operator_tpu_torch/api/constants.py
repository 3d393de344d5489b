"""Environment variables the controller injects into pods, as the runner
reads them.  A copy of the names in tf_operator_tpu/api/constants.py (the
port imports nothing of the JAX package); the values must stay identical,
since the same controller sets them."""

# TF_CONFIG is kept byte-compatible with the TFJob reference.
ENV_TF_CONFIG = "TF_CONFIG"
# Coordination and topology env.
ENV_COORDINATOR_ADDRESS = "TPUJOB_COORDINATOR_ADDRESS"
ENV_PROCESS_ID = "TPUJOB_PROCESS_ID"
ENV_NUM_PROCESSES = "TPUJOB_NUM_PROCESSES"
ENV_MESH_SHAPE = "TPUJOB_MESH_SHAPE"  # json dict axis->size, e.g. {"dp":2,"tp":4}
# "1" => shard optimizer state + weight update over the dp axis (ZeRO-style)
ENV_ZERO_SHARD_WEIGHT_UPDATE = "TPUJOB_ZERO_SHARD_WEIGHT_UPDATE"
ENV_SLICE_TOPOLOGY = "TPUJOB_SLICE_TOPOLOGY"
ENV_ACCELERATOR = "TPUJOB_ACCELERATOR"
ENV_REPLICA_TYPE = "TPUJOB_REPLICA_TYPE"
ENV_REPLICA_INDEX = "TPUJOB_REPLICA_INDEX"
# Elastic virtual-replica mapping: V virtual replicas multiplexed onto P
# physical replicas; each physical worker hosts {j : j % P == replica_index}.
ENV_VIRTUAL_REPLICAS = "TPUJOB_VIRTUAL_REPLICAS"
ENV_PHYSICAL_REPLICAS = "TPUJOB_PHYSICAL_REPLICAS"
ENV_ELASTIC_GENERATION = "TPUJOB_ELASTIC_GENERATION"
# Test/user override of the device (never injected): "cpu" runs the port on
# the CPU with the kernels' plain versions.
ENV_FORCE_PLATFORM = "TPUJOB_FORCE_PLATFORM"
# Multislice (DCN) document the controller injects into a worker group that
# spans several slices (controller/topology.py:_add_multislice_env).
ENV_MEGASCALE_COORDINATOR = "MEGASCALE_COORDINATOR_ADDRESS"
ENV_MEGASCALE_NUM_SLICES = "MEGASCALE_NUM_SLICES"
ENV_MEGASCALE_SLICE_ID = "MEGASCALE_SLICE_ID"
# User default of the parameter-server transport, "python" or "native"
# (never injected).
ENV_PS_TRANSPORT = "TPUJOB_PS_TRANSPORT"
# The local device count L of a pod on the CPU (TPUJOB_FORCE_PLATFORM=cpu),
# the counterpart of XLA's --xla_force_host_platform_device_count in the
# CPU tests (never injected; on CUDA, L is torch.cuda.device_count()).  The
# pod launcher (workloads/launch.py) runs L processes.
ENV_CPU_DEVICE_COUNT = "TPUJOB_CPU_DEVICE_COUNT"
# What the pod launcher gives each of its processes, under torchrun's
# names: its local rank and L.  The TPUJOB_* variables stay the pod's.
ENV_LOCAL_RANK = "LOCAL_RANK"
ENV_LOCAL_WORLD_SIZE = "LOCAL_WORLD_SIZE"
# The launcher's pid, so a process it starts can tell that its pod is gone.
ENV_LAUNCHER_PID = "TPUJOB_LAUNCHER_PID"
