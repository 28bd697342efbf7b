"""Framework-wide constants.

Mirrors `pkg/type/const.go:7-52` and the storage-class name table in
`pkg/utils/const.go:10-22`, plus the GPU-share resource names from the vendored
open-gpu-share (`vendor/github.com/alibaba/open-gpu-share/pkg/utils/const.go:3-9`).
"""

SIMON_PLUGIN = "Simon"
OPEN_LOCAL_PLUGIN = "Open-Local"
OPEN_GPU_SHARE_PLUGIN = "Open-Gpu-Share"
NEW_NODE_NAME_PREFIX = "simon"
DEFAULT_SCHEDULER_NAME = "default-scheduler"

ANNO_WORKLOAD_KIND = "simon/workload-kind"
ANNO_WORKLOAD_NAME = "simon/workload-name"
ANNO_WORKLOAD_NAMESPACE = "simon/workload-namespace"
ANNO_NODE_LOCAL_STORAGE = "simon/node-local-storage"
ANNO_POD_LOCAL_STORAGE = "simon/pod-local-storage"
ANNO_NODE_GPU_SHARE = "simon/node-gpu-share"

LABEL_NEW_NODE = "simon/new-node"
LABEL_APP_NAME = "simon/app-name"
LABEL_HOSTNAME = "kubernetes.io/hostname"
LABEL_ZONE = "topology.kubernetes.io/zone"
LABEL_ZONE_BETA = "failure-domain.beta.kubernetes.io/zone"
# failure-domain label the fault subsystem (simtpu/faults) keys rack-outage
# scenarios off; kubernetes standardizes no rack key, so simtpu owns one
LABEL_RACK = "simtpu.io/rack"

ENV_MAX_CPU = "MaxCPU"
ENV_MAX_MEMORY = "MaxMemory"
ENV_MAX_VG = "MaxVG"

NOTES_FILE_SUFFIX = "NOTES.txt"
SEPARATE_SYMBOL = "-"
WORKLOAD_HASH_DIGITS = 10
POD_HASH_DIGITS = 5
MAX_NUM_NEW_NODE = 100

# workload kind names (pkg/type/const.go:36-43)
KIND_POD = "Pod"
KIND_DEPLOYMENT = "Deployment"
KIND_RS = "ReplicaSet"
KIND_RC = "ReplicationController"
KIND_STS = "StatefulSet"
KIND_DS = "DaemonSet"
KIND_JOB = "Job"
KIND_CRON_JOB = "CronJob"

# open-local / yoda storage-class names (pkg/utils/const.go:10-22)
SC_LVM = ("open-local-lvm", "yoda-lvm-default")
SC_DEVICE_SSD = (
    "open-local-device-ssd",
    "open-local-mountpoint-ssd",
    "yoda-mountpoint-ssd",
    "yoda-device-ssd",
)
SC_DEVICE_HDD = (
    "open-local-device-hdd",
    "open-local-mountpoint-hdd",
    "yoda-mountpoint-hdd",
    "yoda-device-hdd",
)

# open-gpu-share resource names (vendor open-gpu-share utils/const.go:3-9)
RES_GPU_MEM = "alibabacloud.com/gpu-mem"
RES_GPU_COUNT = "alibabacloud.com/gpu-count"
ANNO_POD_GPU_MEM = "alibabacloud.com/gpu-mem"
ANNO_POD_GPU_COUNT = "alibabacloud.com/gpu-count"
ANNO_POD_GPU_INDEX = "alibabacloud.com/gpu-index"
LABEL_GPU_CARD_MODEL = "alibabacloud.com/gpu-card-model"

# terminal colors for progress output (pkg/utils/const.go:3-8)
COLOR_RESET = "\033[0m"
COLOR_RED = "\033[31m"
COLOR_GREEN = "\033[32m"
COLOR_YELLOW = "\033[33m"
COLOR_CYAN = "\033[36m"
