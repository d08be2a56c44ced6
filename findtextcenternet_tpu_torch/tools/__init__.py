"""Command-line tools of the port: benches, checks, annotation and
visualisation (``python -m findtextcenternet_tpu_torch.tools.<name>``)."""

# the small Transformer of the tools' ``--tiny`` runs (CPU runs and tests)
TINY_TRANSFORMER = dict(embed_dim=32, head_num=4, enc_block_num=1,
                        dec_block_num=1, max_enc_seq_len=16,
                        max_dec_seq_len=16)
