from im23d_tpu_torch.serve.export import (  # noqa: F401
    export_callable,
    export_gan_inference,
    export_reconstruction_inference,
    load_artifact,
    save_artifact,
)
