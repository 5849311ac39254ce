"""Host data pipeline of the port: frame readers and writers, augmentation, datasets, the loader and the device prefetcher. numpy only, apart from prefetch.py."""
