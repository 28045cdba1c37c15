"""The port's benchmark: training throughput, step tail and memory of
``deepfbsdejsolvers_torch`` on the reference's configurations (README.md)."""
