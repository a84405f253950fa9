from predictionio_tpu_torch.e2.engine import (  # noqa: F401
    BinaryVectorizer,
    CategoricalNaiveBayes,
    MarkovChain,
)
from predictionio_tpu_torch.e2.evaluation import k_fold_split  # noqa: F401
