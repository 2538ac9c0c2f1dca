"""The control plane's accelerator seams for an H100 slice: the pod spec
of a notebook's StatefulSet and of a warm pool slice."""
