"""Training on several processes, one device each (the counterpart of
``yolov7_d2_tpu/parallel/``, where one jitted step spans a mesh of every
device): process groups and their helpers (``dist``), the (data, model)
grid and tensor parallelism over its model axis (``mesh``), the launcher
(``launch``), synchronized BatchNorm (``norm_sync``) and the
multi-process dryrun (``dryrun``)."""
