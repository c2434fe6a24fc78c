"""The served language models (dense and moe families), decode path."""
