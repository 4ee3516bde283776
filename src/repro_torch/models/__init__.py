"""Model code of the port: dense GQA decoders."""
