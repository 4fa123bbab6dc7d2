from repro_torch.data.synthetic import (  # noqa: F401
    LogRegData, TokenStream, corrupt_labels_lm, corrupt_labels_logreg,
    init_logreg_params, logreg_loss, make_logreg_data,
)
