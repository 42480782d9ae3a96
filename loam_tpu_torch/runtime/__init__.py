"""The online runtime (counterpart of loam_tpu/runtime/): the threaded
streaming engine over the native drop-oldest queues."""
