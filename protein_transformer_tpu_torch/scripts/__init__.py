"""The port's dataset and checkpoint tools, each run as
``python -m protein_transformer_tpu_torch.scripts.<name>``: counterparts of
the ``ptt_scripts`` that compute through the JAX package
(``proteinnet_to_dataset``, ``dataset_item_to_pdb``,
``export_embeddings_to_tsv``)."""
