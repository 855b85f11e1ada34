from .disentangle import Barcodes, estimate_abundances, read_barcodes_csv
