"""The benchmark's inputs, made from the seed by frozen copies of the port's
generators (reference/plain/frontend/synthetic.py and bag_synth.py, the
port's frontend/synthetic.py and frontend/bag_synth.py as the benchmark
was defined): the same seed gives the same scans and the same bag."""
