"""The port's dataset, checkpoint and analysis tools, each run as
``python -m protein_transformer_tpu_torch.scripts.<name>``: counterparts of
the ``ptt_scripts`` (``proteinnet_to_dataset``, ``dataset_item_to_pdb``,
``export_embeddings_to_tsv``, ``compute_dataset_angle_means``,
``create_development_datasets``, ``downsample_dataset``,
``group_predictions``, ``analyze``, ``plot``)."""
