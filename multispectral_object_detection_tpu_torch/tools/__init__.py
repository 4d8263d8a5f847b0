"""The repository's tools on the port, each run as
``python -m multispectral_object_detection_tpu_torch.tools.<name>`` with
the flags of its counterpart under the root ``tools/``:

- ``dataset_tools``: autosplit, extract-boxes, flatten;
- ``export_torch_ckpt``: a pickled reference checkpoint to a state dict;
- ``resume_runs``: restart the interrupted training runs under a root;
- ``profile_model``: device time of the serving forward by kernel and by
  kind of operation (``torch.profiler``);
- ``mfu``: FLOPs per pair or per train step, and the share of the card's
  peak a measured rate reaches.
"""
