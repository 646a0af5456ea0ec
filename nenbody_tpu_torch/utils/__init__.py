"""Host-side utilities of the PyTorch port (counterpart of nenbody_tpu/utils):
checkpoints, profiling, numeric debug aids, the native host runtime and
serving export."""
