"""Leave-one-out hit@10 of the Universal Recommender on app ``MyShop``,
over the minLLR grid of ``evaluation.MinLlrGrid``::

    pio eval predictionio_tpu_torch.examples.universal_recommender.evaluation.UREvaluation \\
             predictionio_tpu_torch.examples.universal_recommender.evaluation.MinLlrGrid
"""
