"""The tools that drive the engine (llama.cpp's cli, perplexity, bench,
tokenize and compare-bench analogs), on the card unless `--device cpu`."""
