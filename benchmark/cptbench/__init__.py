"""The benchmark harness of ``cuda_path_tracer_ss_torch`` (see
``benchmark/README.md``). Importing it imports nothing of the program."""
