__version__ = "0.1.0"
INDEX_FORMAT_VERSION = 2
